"""Decoder for few blocks of any size: the CUDA kernels (one LZ4 block spread
over the whole card), its plain version, the bytes-level batch API, and a
model of the kernels' steps (``decode_v4_segmented_plain``) that the tests
hold equal to the plain version.

Counterpart of ``lz4tpu/kernels/decompress_v4.py``: the decoder for
batches too small for the lane path and for ``lane_kernel=False``.  The
frame path also sends it the blocks of frames of blocks over 64 KiB by
default; ``decodebig.decode_big`` takes them with ``lane_kernel=True``.
The TPU version's ``V4_MAX_COMP``/``V4_MAX_OUT``
limits were SMEM/VMEM workarounds and have no counterpart: comp and output
live in device memory.  Tensor contract: the same as ``decode128``.

The kernels' steps (``csrc/decode_v4.cu``), each a launch on the caller's
stream:

1. every segment of ``SEGMENT`` compressed bytes is walked by a warp as if a
   token started at its first byte, up to the first token at or past the
   next segment (the walk reads shapes only: lengths, offsets and the
   structural ends of the stream, never an output position); each lane
   walks 1/32 of the segment and on to where another lane's walk goes on
   (``_walk_by_parts``);
2. a thread per segment brings it in step with the exit of the walk before
   it: from that entry it parses a head of sequences up to the first token
   its walk also visited; a segment still out of step after ``HEAD`` of them
   is walked again from the entry, by a warp as in step 1; then one
   thread block per LZ4 block finds the true chain: a segment's entry is
   the largest exit of the segments before it, and segments are brought in
   step with their entries in rounds until nothing changes; after
   ``ROUNDS`` rounds one thread finishes the chain serially.  It then
   counts each segment's sequences and output bytes and scans them;
3. every sequence gets its output position and the checks of the shared
   parser in their order; the first failing one sets ``status`` and
   ``out_len``;
4. literals are written, every match byte gets the output position it reads
   (``V[op - offset + (j mod offset)]``), pointer doubling resolves each to
   a literal or prefix byte, and one gather writes the matches.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import build
from ..runtime import KernelStats, round_up
from .decode128 import (
    check_decode_args,
    decode_plain,
    decompress_batch,
    launch_decoder,
)
from .decodebig import SHAPE_OK, check_seq, parse_shape
from .status import OK

KERNEL = KernelStats("decode_v4")
SOURCE = "lz4tpu_torch/csrc/decode_v4.cu"
REPLACES = "lz4tpu/kernels/decompress_v4.py:89"

# the constants of csrc/decode_v4.cu the model shares (a test holds them
# equal to the source's):
#: compressed bytes a speculative walk starts from (SEG)
SEGMENT = 2048
#: parallel verification rounds before the serial finish
ROUNDS = 4
#: pointer hops a doubling round takes
HOPS = 7
#: sequences a segment parses from its entry to meet its walk before it
#: walks the whole segment again
HEAD = 128


def decode_v4(comp, comp_len, prefix, prefix_len, limit: int, out_capacity=None):
    """Decode a batch of blocks of any size; the CUDA kernels for CUDA
    tensors, the plain version (``decode128.decode_plain``, the same
    function) for CPU tensors."""
    if out_capacity is None:
        out_capacity = round_up(limit + comp.shape[1], 16)
    check_decode_args("decode_v4", comp, comp_len, prefix, prefix_len, limit, out_capacity)
    if out_capacity >= 1 << 31 or comp.shape[1] >= 1 << 31:
        raise ValueError("decode_v4: out_capacity and the comp width must stay below 2 GiB")
    if comp.is_cuda:
        lib = build.load()
        # scratch for one group of blocks; the kernels take the batch a
        # group after another (csrc/decode_v4.cu SCRATCH_BUDGET)
        size = lib.lz4t_decode_v4_scratch(comp.shape[0], comp.shape[1], out_capacity)
        scratch = torch.empty(max(size, 1), dtype=torch.uint8, device=comp.device)
        return launch_decoder(KERNEL, "lz4t_decode_v4", comp, comp_len, prefix, prefix_len,
                              limit, out_capacity, extra=(scratch.data_ptr(), size))
    if comp.device.type == "cpu":
        return decode_plain(comp, comp_len, prefix, prefix_len, limit, out_capacity)
    raise ValueError(f"decode_v4: unsupported device {comp.device}")


def decompress_blocks_v4(blocks, prefixes=None, block_maxsize: int = 1 << 16, device=None):
    """Batch decode, one call a group of blocks under ``DECODE_BUDGET``;
    raises ``DecodeError`` for the first failing block.  Any comp or
    output size that fits in device memory."""
    return decompress_batch(decode_v4, blocks, block_maxsize, prefixes, device)


# ---------------------------------------------------------------------------
# a model of the kernels' steps, for the tests (``decode_plain`` is the
# specification)
# ---------------------------------------------------------------------------

END = (1 << 31) - 1  # a walk's exit when the chain ends inside it


def _walk(comp: bytes, pos: int, seg_end: int, limit: int):
    """A walk from ``pos`` to the first token at or past ``seg_end``: its
    records (pos, code, lit_src, lit_len, match_len, offset) and its exit
    (``END`` when the chain ends inside it).
    Match lengths are kept at most ``limit + 1``, which fails the same
    check and keeps them in 32 bits."""
    n = len(comp)
    records = []
    while True:
        if pos >= n:
            return records, END
        code, nxt, lit_src, lit, ml, offset = parse_shape(comp, pos)
        records.append((pos, code, lit_src, lit, min(ml, limit + 1), offset))
        if code != SHAPE_OK:
            return records, END
        pos = nxt
        if pos >= seg_end:
            return records, pos


WALKED = 2
def _walk_by_parts(comp: bytes, lo: int, segment: int, limit: int):
    """``_walk(comp, lo, lo + segment, limit)`` as the walk kernel computes
    it: each of 32 lanes walks its part of the segment from the part's
    first byte, then on past the part's end to the first token that the
    walk of the part holding it visited (or out of the segment, or to the
    chain's end); the chain goes from lane to lane.  Returns (records, exit,
    the longest walk past a part's end, in sequences)."""
    n = len(comp)
    end = lo + segment
    part = max(segment // 32, 1)
    lanes = []  # (records, exit) of each part
    seen = {}  # token start -> the part whose own walk visited it
    for k in range(segment // part):
        plo = lo + k * part
        records, exit = _walk(comp, plo, plo + part, limit) if plo < n else ([], END)
        if n <= exit < end:  # the chain ends at the stream's end inside the segment
            exit = END
        for r in records:
            seen[r[0]] = k
        lanes.append([records, exit])
    longest = 0
    for lane in lanes:
        records, exit = lane
        own = len(records)
        while exit != END and exit < end and exit not in seen:
            code, nxt, lit_src, lit, ml, offset = parse_shape(comp, exit)
            records.append((exit, code, lit_src, lit, min(ml, limit + 1), offset))
            exit = END if code != SHAPE_OK or n <= nxt < end else nxt
        lane[1] = exit
        longest = max(longest, len(records) - own)
    chain, k, e = [], 0, lo
    while True:
        records, exit = lanes[k]
        chain += records[[r[0] for r in records].index(e) :]
        if exit == END or exit >= end:
            return chain, exit, longest
        k, e = seen[exit], exit


class _Segment:
    """A segment's state in the verify kernel: its walk (the speculative one
    from its first byte, or a whole walk again from an entry), the entry it
    was last brought in step with, and its part of the chain: a head of at
    most ``HEAD`` sequences parsed from that entry up to the first token
    the walk also visited, then the walk from there (the tail)."""

    def __init__(self, comp, j, segment, limit):
        self.lo, self.end = j * segment, (j + 1) * segment
        self.walk(comp, self.lo, limit)
        self.head, self.tail = [], 0

    def walk(self, comp, start, limit):
        if start == self.lo:  # the walk kernel's
            self.records, self.walk_exit, self.longest = _walk_by_parts(
                comp, start, self.end - self.lo, limit)
        else:
            self.records, self.walk_exit = _walk(comp, start, self.end, limit)
        self.seen = {r[0]: k for k, r in enumerate(self.records)}
        self.entry, self.exit, self.empty = start, self.walk_exit, False

    def chain(self):
        return [] if self.empty else self.head + self.records[self.tail :]

    def settle(self, comp, entry, limit) -> int:
        """Bring the segment in step with ``entry``: 0 if nothing changed,
        ``WALKED`` if it walked the segment again, else 1.  An entry at or
        past the segment's end, or past the stream's, leaves it without a
        token of the chain."""
        n = len(comp)
        if entry >= self.end or entry >= n:
            changed = not (self.empty and self.entry == entry)
            self.empty, self.entry, self.exit = True, entry, entry
            return changed
        if not self.empty and self.entry == entry:
            return False
        self.empty, self.entry, self.head = False, entry, []
        pos = entry
        while True:
            if pos >= n or pos >= self.end:  # the chain ends, or leaves the segment
                self.tail, self.exit = len(self.records), END if pos >= n else pos
                return True
            if pos in self.seen:  # in step with the walk from here on
                self.tail, self.exit = self.seen[pos], self.walk_exit
                return True
            if len(self.head) == HEAD:  # out of step for long: walk again
                self.walk(comp, entry, limit)
                self.head, self.tail = [], 0
                return WALKED
            code, nxt, lit_src, lit, ml, offset = parse_shape(comp, pos)
            self.head.append((pos, code, lit_src, lit, min(ml, limit + 1), offset))
            if code != SHAPE_OK:
                self.tail, self.exit = len(self.records), END
                return True
            pos = nxt


def decode_block_segmented_plain(comp: bytes, prefix: bytes, limit: int, out_capacity: int,
                                 segment: int = SEGMENT, rounds: int = ROUNDS):
    """One block by the kernels' steps.  Returns (output bytes, status,
    info): ``info`` gives the longest walk of a lane past its part of a
    segment, counts the verification rounds that changed something and the
    segments each changed, the segments walked again in full,
    whether the serial finish ran and the segments it changed, and the
    pointer-doubling rounds that changed something."""
    n = len(comp)
    plen = len(prefix)
    m = -(-n // segment)
    segs = [_Segment(comp, j, segment, limit) for j in range(m)]
    info = dict(segments=m, longest=max((s.longest for s in segs), default=0), rounds=0,
                changed=[], walks=0, serial=False, serial_changed=0, doubling=0)
    # the resync pass: each segment in step with the walk before it
    first_exits = [s.exit for s in segs]
    for s, e in zip(segs[1:], first_exits):
        info["walks"] += s.settle(comp, e, limit) == WALKED
    # verification: a segment's entry is the largest exit before it
    converged = m == 0
    for _ in range(rounds):
        entries = np.maximum.accumulate([0] + [s.exit for s in segs[:-1]])
        changed = [s.settle(comp, int(e), limit) for s, e in zip(segs, entries)]
        if not any(changed):
            converged = True
            break
        info["rounds"] += 1
        info["changed"].append(sum(map(bool, changed)))
        info["walks"] += changed.count(WALKED)
    if not converged:  # the serial finish
        info["serial"] = True
        e = 0
        for s in segs:
            changed = s.settle(comp, e, limit)
            info["serial_changed"] += bool(changed)
            info["walks"] += changed == WALKED
            e = s.exit
    # the true chain, segment by segment, and every sequence's position
    chain = [r for s in segs for r in s.chain()]
    ops = np.concatenate(([0], np.cumsum([r[3] + r[4] for r in chain], dtype=np.int64)))
    status, valid = OK, len(chain)
    for i, (_, code, _, lit, ml, offset) in enumerate(chain):
        st = check_seq(code, lit, ml, offset, int(ops[i]), plen, limit, out_capacity)
        if st != OK:  # the first failure in stream order
            status, valid = st, i
            break
    out_len = int(ops[valid])
    # literals, then each match byte's source resolved by pointer doubling
    out = np.zeros(out_len, np.uint8)
    src = np.arange(out_len, dtype=np.int64)  # a literal byte is its own source
    comp_np = np.frombuffer(comp, np.uint8)
    for i, (_, _, lit_src, lit, ml, offset) in enumerate(chain[:valid]):
        op = int(ops[i])
        out[op : op + lit] = comp_np[lit_src : lit_src + lit]
        mop = op + lit
        j = np.arange(ml, dtype=np.int64)
        src[mop : mop + ml] = mop - offset + j % offset
    own = np.arange(out_len)
    while True:  # rounds of HOPS hops along the pointers as the round found them
        v = src.copy()
        for _ in range(HOPS):
            hop = (v >= 0) & (v != own)
            hop[hop] = src[v[hop]] != v[hop]  # not yet a literal
            v[hop] = src[v[hop]]
        if np.array_equal(v, src):
            break
        src = v
        info["doubling"] += 1
    match = src != np.arange(out_len)
    pre = np.frombuffer(prefix, np.uint8)
    from_out = match & (src >= 0)
    from_pre = match & (src < 0)
    out[from_out] = out[src[from_out]]
    out[from_pre] = pre[plen + src[from_pre]]
    return out.tobytes(), status, info


def decode_v4_segmented_plain(comp, comp_len, prefix, prefix_len, limit: int, out_capacity: int,
                              segment: int = SEGMENT, rounds: int = ROUNDS):
    """``decode_plain`` by the kernels' steps on CPU tensors, used by the
    tests only.  Returns (out, out_len, status, infos), one ``info`` dict
    of ``decode_block_segmented_plain`` a block."""
    n_blocks = comp.shape[0]
    comp_np, pre_np = comp.numpy(), prefix.numpy()
    pw = prefix.shape[1]
    out = torch.zeros((n_blocks, out_capacity), dtype=torch.uint8)
    out_np = out.numpy()
    out_len = torch.zeros(n_blocks, dtype=torch.int32)
    status = torch.zeros(n_blocks, dtype=torch.int32)
    infos = []
    for i in range(n_blocks):
        row = pre_np[0 if pre_np.shape[0] == 1 else i]
        plen = int(prefix_len[i])
        pfx = row[pw - plen :].tobytes() if plen else b""
        data, st, info = decode_block_segmented_plain(
            comp_np[i, : int(comp_len[i])].tobytes(), pfx, limit, out_capacity, segment, rounds)
        out_np[i, : len(data)] = np.frombuffer(data, np.uint8)
        out_len[i] = len(data)
        status[i] = st
        infos.append(info)
    return out, out_len, status, infos
