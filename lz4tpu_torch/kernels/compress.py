"""Raw-block greedy compressor: the CUDA kernel, its plain version, and the
batch and single-block host APIs.

Counterpart of ``lz4tpu/kernels/compress.py``.  The greedy parse of the
reference (``src/raw/compress/mod.rs:147-260``) is serial in what it
decides, not in its work: one block is one warp's parse
(``csrc/compress.cu``), which probes 32 positions of the skip schedule at
once and takes the first hit, the match the serial loop takes.
``parse_plain`` is the serial loop and the specification;
``parse_batched_plain`` follows the kernel's steps and is held equal to it
by the tests.

One row on many warps (``compress_split``, the frame path's independent
rows without a dictionary, where ``split_seam`` finds a row long enough):
the row is cut at seams ``S`` apart, each segment's warp runs the same
parse from its seam on an empty table, a run hands the row over to a later
segment's where their records prove the two parses agree from there on,
and a second launch stitches the proven pieces.  ``parse_split_plain`` is
its plain version, held byte-equal to ``parse_plain`` by the tests.

Tensor contract of ``compress_batch`` (kernel and plain version alike):

* ``data`` (N, C) uint8 — row i holds ``[prefix | block]``, ``n[i]`` bytes;
* ``n``, ``cursor``, ``cap`` (<0: none), ``accel``, ``toff``, ``prime``:
  (N,) int32 per-block scalars (parse start, output cap, acceleration,
  table offset, 1 = prime the table from ``data[:cursor]``);
* ``tables`` (N, S) int32 slot bits, S = 4096 (U32) or 8192 (U16);
* returns ``out`` (N, W) uint8 (zero past ``out_len``), ``out_len``,
  ``status`` (``STATUS_OK`` / ``STATUS_INCOMPRESSIBLE``) and the post-parse
  ``tables`` — mutated up to the abort point on Incompressible, like the
  reference's ``NoPartialWrites``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import build, hostpack
from ..runtime import KernelStats, resolve_device, round_up, stream_handle
from ..spec.block import (
    LAST_LITERALS,
    MFLIMIT,
    MINMATCH,
    SKIP_TRIGGER,
    BlockTooBig,
    Incompressible,
    compress_bound,
)
from ..spec.table import U16_SLOTS, U32_SLOTS, U16Table, U32Table, hash_all_u16, hash_all_u32
from ..state import tables_from_jax
from .status import STATUS_INCOMPRESSIBLE, STATUS_OK

KERNEL = KernelStats("compress")
SPLIT_KERNEL = KernelStats("compress_split")
SOURCE = "lz4tpu_torch/csrc/compress.cu"
REPLACES = "lz4tpu/kernels/compress.py:71"


def _check(data, scalars, tables, out_capacity):
    if data.dtype != torch.uint8 or data.dim() != 2 or not data.is_contiguous():
        raise ValueError("compress: data must be a contiguous (N, C) uint8 tensor")
    n_blocks = data.shape[0]
    for name, t in scalars.items():
        if t.dtype != torch.int32 or t.shape != (n_blocks,) or not t.is_contiguous():
            raise ValueError(f"compress: {name} must be a contiguous ({n_blocks},) int32 tensor")
        if t.device != data.device:
            raise ValueError(f"compress: {name} is on {t.device}, data on {data.device}")
    if (
        tables.dtype != torch.int32
        or tables.dim() != 2
        or tables.shape[0] != n_blocks
        or tables.shape[1] not in (U32_SLOTS, U16_SLOTS)
        or not tables.is_contiguous()
    ):
        raise ValueError("compress: tables must be a contiguous (N, 4096|8192) int32 tensor")
    if tables.device != data.device:
        raise ValueError(f"compress: tables are on {tables.device}, data on {data.device}")
    if out_capacity <= 0:
        raise ValueError("compress: out_capacity must be positive")


def compress_batch(data, n, cursor, cap, accel, toff, prime, tables, out_capacity=None):
    """Compress a batch of blocks; the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors (see the module docstring)."""
    if out_capacity is None:
        out_capacity = round_up(compress_bound(data.shape[1]), 16)
    scalars = dict(n=n, cursor=cursor, cap=cap, accel=accel, toff=toff, prime=prime)
    _check(data, scalars, tables, out_capacity)
    if data.is_cuda:
        return _compress_cuda(data, n, cursor, cap, accel, toff, prime, tables, out_capacity)
    if data.device.type == "cpu":
        return compress_plain(data, n, cursor, cap, accel, toff, prime, tables, out_capacity)
    raise ValueError(f"compress: unsupported device {data.device}")


def _compress_cuda(data, n, cursor, cap, accel, toff, prime, tables, out_capacity):
    lib = build.load()
    n_blocks, s = tables.shape
    out = torch.zeros((n_blocks, out_capacity), dtype=torch.uint8, device=data.device)
    out_len = torch.empty(n_blocks, dtype=torch.int32, device=data.device)
    status = torch.empty(n_blocks, dtype=torch.int32, device=data.device)
    table_out = torch.empty_like(tables)
    with torch.cuda.device(data.device):
        h = KERNEL.begin()
        rc = lib.lz4t_compress(
            data.data_ptr(), data.stride(0), n.data_ptr(), cursor.data_ptr(), cap.data_ptr(),
            accel.data_ptr(), toff.data_ptr(), prime.data_ptr(), tables.data_ptr(),
            table_out.data_ptr(), s, out.data_ptr(), out_capacity, out_len.data_ptr(),
            status.data_ptr(), n_blocks, stream_handle(),
        )
        KERNEL.end(h)
    build.check(rc, "compress")
    return out, out_len, status, table_out


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def _lcp(data: bytes, a: int, a_end: int, b: int, n: int) -> int:
    """Longest common prefix of data[a:a_end] and data[b:n]."""
    limit = min(a_end - a, n - b)
    m = 0
    while m + 16 <= limit and data[a + m : a + m + 16] == data[b + m : b + m + 16]:
        m += 16
    while m < limit and data[a + m] == data[b + m]:
        m += 1
    return m


def _lsic(out: bytearray, v: int) -> None:
    if v >= 0xF:
        v -= 0xF
        out.extend(b"\xff" * (v // 0xFF))
        out.append(v % 0xFF)


def _lsic_len(v: int) -> int:
    return 0 if v < 0xF else (v - 0xF) // 0xFF + 1


def _sequences(data: bytes, hashes: list, start: int, init_cursor: int, acceleration: int,
               toff: int, tab: list, mask: int):
    """The greedy parse of ``data`` from ``start``, one sequence at a time:
    ``(literal_start, hit, candidate, end, backtrack)`` for a match (the
    probe that hit, its candidate, the match's end, the bytes it extends
    backwards), then ``(literal_start, -1, -1, n, 0)`` for the tail.  Each
    sequence's table inserts are made before it is yielded; ``tab`` is
    mutated in place."""
    n = len(data)
    cursor = start
    while cursor < n:
        literal_start = cursor
        step_counter = acceleration << SKIP_TRIGGER
        step = 1
        while True:
            if cursor + step > n - (LAST_LITERALS - 1):
                yield literal_start, -1, -1, n, 0
                return
            h = hashes[cursor]
            candidate = max(tab[h] - toff, 0)
            tab[h] = (cursor + toff) & mask
            if cursor != init_cursor and cursor - candidate <= 0xFFFF:
                matching = _lcp(data, cursor, n - MFLIMIT, candidate, n)
                if matching >= MINMATCH:
                    bt = 0
                    max_bt = cursor - literal_start
                    while (
                        bt < max_bt
                        and candidate - bt > 0
                        and data[cursor - bt - 1] == data[candidate - bt - 1]
                    ):
                        bt += 1
                    hit = cursor
                    cursor += matching
                    tab[hashes[cursor - 2]] = (cursor - 2 + toff) & mask
                    yield literal_start, hit, candidate, cursor, bt
                    break
            cursor += step
            if literal_start + 1 != cursor:
                step = step_counter >> SKIP_TRIGGER
                step_counter += 1


def _group_len(seq) -> int:
    """The bytes of a sequence of ``_sequences`` in the block format."""
    literal_start, hit, candidate, end, bt = seq
    if hit < 0:
        literal_len = end - literal_start
        return 1 + _lsic_len(literal_len) + literal_len
    literal_len = hit - bt - literal_start
    return 1 + _lsic_len(literal_len) + literal_len + 2 + _lsic_len(end - hit - MINMATCH + bt)


def _put_group(out: bytearray, data: bytes, seq) -> None:
    """Append a sequence of ``_sequences`` to ``out`` in the block format."""
    literal_start, hit, candidate, end, bt = seq
    if hit < 0:
        literal_len = end - literal_start
        out.append(min(literal_len, 0xF) << 4)
        _lsic(out, literal_len)
        out += data[literal_start:end]
        return
    literal_end = hit - bt
    literal_len = literal_end - literal_start
    extra = end - hit - MINMATCH + bt
    offset = hit - candidate
    out.append((min(literal_len, 0xF) << 4) | min(extra, 0xF))
    _lsic(out, literal_len)
    out += data[literal_start:literal_end]
    out.append(offset & 0xFF)
    out.append((offset >> 8) & 0xFF)
    _lsic(out, extra)


def parse_plain(data: bytes, init_cursor: int, cap: int, acceleration: int, toff: int,
                prime: bool, tab: list, u16: bool, out_capacity: int):
    """One block's greedy parse, the kernel's steps in Python.  ``tab`` (a
    list of slot values) is mutated in place.  Returns (bytes, status)."""
    n = len(data)
    hashes = (hash_all_u16(data) if u16 else hash_all_u32(data)).tolist()
    mask = 0xFFFF if u16 else 0xFFFFFFFF
    cap = (1 << 62) if cap < 0 else cap
    if prime and init_cursor >= 8:
        for p in range(0, init_cursor - 7, 3):
            tab[hashes[p]] = (p + toff) & mask
    out = bytearray()
    for seq in _sequences(data, hashes, min(init_cursor, n), init_cursor, acceleration, toff,
                          tab, mask):
        group = _group_len(seq)
        if len(out) + group > cap or len(out) + group > out_capacity:
            return bytes(out), STATUS_INCOMPRESSIBLE
        _put_group(out, data, seq)
    return bytes(out), STATUS_OK


WARP = 32


def _probe(k: int, literal_start: int, acceleration: int):
    """(position, step) of probe ``k`` of a search that began at
    ``literal_start``, in closed form: advances go 1, 1, a, a, ... with the
    step assignment lagging one miss, so step(k) = a + ((k - 2) >> 6)."""
    if k < 2:
        return literal_start + k, 1
    m = k - 2
    q, r = m >> SKIP_TRIGGER, m & ((1 << SKIP_TRIGGER) - 1)
    return literal_start + 2 + m * acceleration + 32 * q * (q - 1) + q * r, acceleration + q


def _lcp_rounds(data: bytes, a: int, a_end: int, b: int, n: int, m: int = 0) -> int:
    """``_lcp`` as the warp takes it, from ``m`` bytes known to be equal: 4
    bytes a lane, 128 a round, the first lane that stops (a difference, or
    the limit inside its share) decides."""
    limit = min(a_end - a, n - b)
    while True:
        for lane in range(WARP):
            off = m + 4 * lane
            share = min(limit - off, 4)
            cnt = 0
            while cnt < share and data[a + off + cnt] == data[b + off + cnt]:
                cnt += 1
            if cnt < 4:
                return off + cnt
        m += 4 * WARP


def parse_batched_plain(data: bytes, init_cursor: int, cap: int, acceleration: int, toff: int,
                        prime: bool, tab: list, u16: bool, out_capacity: int):
    """One block's greedy parse by the CUDA kernel's steps (a model for the
    tests; ``parse_plain`` is the specification): batches of 32 probe
    positions from the skip schedule, every lane reading the table as it
    stood before the batch, in-batch collisions forwarded from the nearest
    lower lane through the slot type, the first hit or tail lane decides,
    and lanes up to it write the table.  Same arguments and results as
    ``parse_plain``."""
    n = len(data)
    hashes = (hash_all_u16(data) if u16 else hash_all_u32(data)).tolist()
    mask = 0xFFFF if u16 else 0xFFFFFFFF
    cap = (1 << 62) if cap < 0 else cap

    def write_group(lanes):
        """Lanes (hash, position) write their slots, the highest lane of a
        hash group last."""
        last = {}
        for h, p in lanes:
            last[h] = p
        for h, p in last.items():
            tab[h] = (p + toff) & mask

    if prime and init_cursor >= 8:
        for p0 in range(0, init_cursor - 7, 3 * WARP):
            write_group([(hashes[p], p)
                         for p in range(p0, min(p0 + 3 * WARP, init_cursor - 7), 3)])
    out = bytearray()
    cursor = min(init_cursor, n)
    while cursor < n:
        literal_start = cursor
        k0 = 0
        while True:
            lanes = []  # (hash, position) of the lanes that probe, in lane order
            hit = None
            tail = False
            for lane in range(WARP):
                p, step = _probe(k0 + lane, literal_start, acceleration)
                if p + step > n - (LAST_LITERALS - 1):
                    tail = True
                    break
                h = hashes[p]
                # the nearest lower lane with this hash, else the slot
                stored = next(((q + toff) & mask for g, q in reversed(lanes) if g == h), tab[h])
                candidate = max(stored - toff, 0)
                lanes.append((h, p))
                if p != init_cursor and p - candidate <= 0xFFFF and candidate + MINMATCH <= n:
                    # the lane holds 8 bytes of both sides: equal bytes among
                    # them, at most the match's limit
                    limit = min(n - MFLIMIT - p, n - candidate)
                    equal = 0
                    while equal < min(8, limit) and data[p + equal] == data[candidate + equal]:
                        equal += 1
                    if equal >= MINMATCH:
                        hit = (p, candidate, equal, equal == 8 and limit > 8)
                        break  # lanes above the first hit change nothing
            write_group(lanes)
            if hit or tail:
                break
            k0 += WARP
        if tail:
            literal_len = n - literal_start
            group = 1 + _lsic_len(literal_len) + literal_len
            if len(out) + group > cap or len(out) + group > out_capacity:
                return bytes(out), STATUS_INCOMPRESSIBLE
            out.append(min(literal_len, 0xF) << 4)
            _lsic(out, literal_len)
            out += data[literal_start:n]
            return bytes(out), STATUS_OK
        cursor, candidate, matching, open_ended = hit
        if open_ended:  # the match goes on past the probe's 8 bytes
            matching = _lcp_rounds(data, cursor, n - MFLIMIT, candidate, n, 8)
        extra = matching - MINMATCH
        offset = cursor - candidate
        max_bt = cursor - literal_start
        bt = 0
        while True:  # 32 bytes a round, the first lane that fails decides
            fails = [t for t in range(bt, bt + WARP)
                     if not (t < max_bt and candidate - t > 0
                             and data[cursor - t - 1] == data[candidate - t - 1])]
            if fails:
                bt = fails[0]
                break
            bt += WARP
        extra += bt
        cursor += matching
        tab[hashes[cursor - 2]] = (cursor - 2 + toff) & mask
        literal_end = cursor - extra - MINMATCH
        literal_len = literal_end - literal_start
        group = 1 + _lsic_len(literal_len) + literal_len + 2 + _lsic_len(extra)
        if len(out) + group > cap or len(out) + group > out_capacity:
            return bytes(out), STATUS_INCOMPRESSIBLE
        out.append((min(literal_len, 0xF) << 4) | min(extra, 0xF))
        _lsic(out, literal_len)
        out += data[literal_start:literal_end]
        out.append(offset & 0xFF)
        out.append((offset >> 8) & 0xFF)
        _lsic(out, extra)
    return bytes(out), STATUS_OK


def compress_batched_plain(data, n, cursor, cap, accel, toff, prime, tables, out_capacity):
    """``compress_plain`` with ``parse_batched_plain`` as the parse: the
    kernel's design on CPU tensors, used by the tests only."""
    return compress_plain(data, n, cursor, cap, accel, toff, prime, tables, out_capacity,
                          parse=parse_batched_plain)


def compress_plain(data, n, cursor, cap, accel, toff, prime, tables, out_capacity,
                   parse=parse_plain):
    """Plain version of the kernel on CPU tensors (same contract)."""
    n_blocks, s = tables.shape
    u16 = s == U16_SLOTS
    rows = data.numpy()
    n_l, cur_l, cap_l = n.tolist(), cursor.tolist(), cap.tolist()
    acc_l, toff_l, prime_l = accel.tolist(), toff.tolist(), prime.tolist()
    tab_in = tables.numpy().view(np.uint32)
    out = torch.zeros((n_blocks, out_capacity), dtype=torch.uint8)
    out_np = out.numpy()
    out_len = torch.zeros(n_blocks, dtype=torch.int32)
    status = torch.zeros(n_blocks, dtype=torch.int32)
    table_out = torch.empty_like(tables)
    tab_out = table_out.numpy().view(np.uint32)
    for i in range(n_blocks):
        tab = tab_in[i].tolist()
        payload, st = parse(
            rows[i, : n_l[i]].tobytes(), cur_l[i], cap_l[i], acc_l[i],
            toff_l[i] & 0xFFFFFFFF, prime_l[i] != 0, tab, u16, out_capacity,
        )
        out_np[i, : len(payload)] = np.frombuffer(payload, np.uint8)
        out_len[i] = len(payload)
        status[i] = st
        tab_out[i] = np.asarray(tab, dtype=np.uint32)
    return out, out_len, status, table_out


# ---------------------------------------------------------------------------
# one row on many warps: the parse cut at seams
# ---------------------------------------------------------------------------

#: the least seam spacing, and the warps a launch aims at for each
#: multiprocessor: ``tools/torch_chip_split_sweep.py`` at full scale (H100
#: 80GB HBM3, 700 W), each Silesia stand-in member's 4 MiB rows in one launch
#: at spacings of 68, 96 and 128 KiB: the 12 members' kernel times sum to
#: 269, 255 and 269 ms (one warp a row: 1,615 ms).  A warp parses its
#: segment and then 150 to 300 KiB more before its records meet the next
#: warp's and stay equal for HANDOFF_SPAN, so the spacing buys little below
#: 96 KiB; 96 KiB over mozilla's 13 rows is 513 warps, about 4 a
#: multiprocessor, the fastest of the four spacings there.
SEAM_FLOOR = 96 << 10
WARPS_PER_SM = 4
#: a launch is split only where its longest row reaches a seam and this
#: much more: segment 0 parses to its hand-off, 150 to 300 KiB past the
#: first seam and then HANDOFF_SPAN of agreement, so in a shorter row it
#: parses most of the row and the other warps, their records and the
#: stitch are cost.  The same sweep at 96 KiB seams, each member's rows in
#: one launch against the one-warp kernel, the 12 members' times summed
#: (and the members' range): 256 KiB rows 0.77 times (0.70-1.09), 512 KiB
#: 0.94 (0.80-1.19), 640 KiB 1.16 (0.89-1.45), 768 KiB 1.24 (0.88-1.64,
#: 5 members under 1), 1 MiB 1.67 (1.11-2.27), 2 MiB 3.23 (1.76-4.49): at
#: the floor's spacing rows of 864 KiB and more split
SPLIT_REACH = 768 << 10
#: records of two runs identical over this many bytes from a common search
#: start prove that the runs agree from there on: every table slot a probe
#: can still use (at most 0xFFFF behind it) was written by the same inserts
HANDOFF_SPAN = 1 << 16
#: the most segments of one row (the stitch's table of pieces)
MAX_SEGMENTS = 64
#: a record: (probe that hit, its candidate, match end, output offset at
#: the search start); the tail's is (-1, -1, n, offset)
RECORD_BYTES = 16
#: long literal runs a warp leaves to the stitch (``csrc/compress.cu``
#: DEFER_CAP), 16 bytes each
DEFERRED_RUNS = 64


@functools.lru_cache(maxsize=None)
def _card_multiprocessors(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def multiprocessors(dev) -> int:
    """The multiprocessors of ``dev``'s card; 1 for the CPU, which runs the
    plain versions one parse at a time."""
    dev = torch.device(dev)
    if dev.type != "cuda":
        return 1
    return _card_multiprocessors(torch.cuda.current_device() if dev.index is None else dev.index)


def split_seam(lens, sms: int):
    """The seam spacing ``S`` of one launch over independent rows of
    ``lens`` on a card of ``sms`` multiprocessors: about ``WARPS_PER_SM``
    warps a multiprocessor over the launch's bytes, in whole 4 KiB, never
    under ``SEAM_FLOOR`` nor over ``MAX_SEGMENTS`` segments a row.
    ``None`` where no row has two segments and reaches ``S + SPLIT_REACH``:
    the launch stays on the one-warp kernel."""
    lens = np.asarray(lens, np.int64)
    if not len(lens):
        return None
    longest = int(lens.max())
    share = int(lens.sum()) // (sms * WARPS_PER_SM) // 4096 * 4096
    seam = max(SEAM_FLOOR, share, round_up(-(-longest // MAX_SEGMENTS), 4096))
    return seam if longest >= seam + max(seam, SPLIT_REACH) else None


def segments(n: int, seam: int) -> int:
    """Segments of a row of ``n`` bytes: seams at ``S, 2S, ...``, the last
    segment from ``(k - 1) S`` to the row's end, at least ``S`` long."""
    return max(n // seam, 1)


def record_capacity(span: int, seam: int) -> int:
    """Records a warp keeps of a parse over ``span`` bytes: one sequence a
    8 bytes (text runs 10 to 13) over its segment, the next one and 768 KiB
    of overlap (the hand-offs measured on the stand-in fall within 600
    KiB).  A warp that fills them parses on to the row's end, and no check
    reads past them, so the cap costs time, never a byte."""
    return min(span, 2 * seam + (768 << 10)) // 8 + 64


class SplitPlan(NamedTuple):
    """The warps of one split launch: ``warps`` (W, 6) int64 rows of (row,
    segment, scratch offset, scratch bytes, first record, records) in row
    order; ``row_first`` (N + 1,) int32, each row's first warp;
    ``scratch_bytes`` and ``records`` in all."""
    warps: object
    row_first: object
    scratch_bytes: int
    records: int


def split_plan(lens, seam: int) -> SplitPlan:
    """The plan of a split launch over rows of ``lens`` (host arrays).  A
    warp's scratch holds the worst case of its parse to the row's end."""
    if seam <= 0xFFFF:
        raise ValueError(f"compress_split: seams {seam} B apart leave an empty slot in reach")
    warps, row_first = [], [0]
    scratch = records = 0
    for r, n in enumerate(np.asarray(lens, np.int64).tolist()):
        if segments(n, seam) > MAX_SEGMENTS:
            raise ValueError(f"compress_split: a row of {n} B in over {MAX_SEGMENTS} segments")
        for k in range(segments(n, seam)):
            span = n - k * seam
            size = round_up(compress_bound(span), 16)
            recs = record_capacity(span, seam)
            warps.append((r, k, scratch, size, records, recs))
            scratch += size
            records += recs
        row_first.append(len(warps))
    return SplitPlan(np.array(warps, np.int64).reshape(-1, 6), np.array(row_first, np.int32),
                     scratch, records)


class _Run:
    """One warp's parse of a row from its first search start (its seam):
    its output, its records and its hand-off ``(target segment, h, own
    offset at h, target's offset at h)``, ``None`` where it parsed to the
    row's end."""

    def __init__(self, first: int):
        self.first = first
        self.out = bytearray()
        self.records = []
        self.handoff = None


def _start(records, i: int, first: int) -> int:
    """The search start of record ``i``: the end of the one before it."""
    return records[i - 1][2] if i else first


class _Compare:
    """Segment ``k``'s check of its records against a later segment's, in
    the kernel's order (``csrc/compress.cu``, ``compare``).  Records
    identical from a common search start ``c0`` up to a common search
    start ``h >= c0 + HANDOFF_SPAN`` prove the hand-off at ``h``.  A target
    whose records are all read and final without a proof gives way to the
    segment it handed off to, else to the one after it (a takeover), and
    the check starts over there."""

    def __init__(self, k: int, n_segments: int, seam: int, runs):
        self.k, self.n_segments, self.seam, self.runs = k, n_segments, seam, runs
        self.tgt = k + 1 if k + 1 < n_segments else -1
        self.i = self.j = 0
        self.anchor = -1

    def _next_target(self):
        hand = self.runs[self.tgt].handoff
        if hand is not None:
            self.tgt = hand[0]
        else:
            self.tgt = self.tgt + 1 if self.tgt + 1 < self.n_segments else -1
        self.j = 0
        self.anchor = -1

    def step(self, own):
        """Compare as far as ``own`` records go: the hand-off, or ``None``."""
        while self.tgt >= 0 and self.i < len(own):
            theirs = self.runs[self.tgt].records
            first = self.runs[self.tgt].first
            c = _start(own, self.i, self.k * self.seam)
            if self.anchor < 0:
                while self.j < len(theirs) and _start(theirs, self.j, first) < c:
                    self.j += 1
                if self.j == len(theirs):
                    self._next_target()
                elif _start(theirs, self.j, first) == c:
                    self.anchor = c
                else:
                    self.i += 1
                continue
            if self.j == len(theirs):
                self._next_target()
                continue
            if c >= self.anchor + HANDOFF_SPAN:
                return self.tgt, c, own[self.i][3], theirs[self.j][3]
            if own[self.i][:3] != theirs[self.j][:3]:
                self.anchor = -1
            self.i += 1
            self.j += 1
        return None


def _split_run(data: bytes, hashes: list, k: int, n_segments: int, seam: int,
               acceleration: int, runs) -> _Run:
    """Segment ``k``'s warp: ``parse_plain``'s loop from the seam on an
    empty table, no cap, stopped at its proven hand-off."""
    n = len(data)
    start = k * seam
    run = _Run(start)
    keep = record_capacity(n - start, seam)
    check = _Compare(k, n_segments, seam, runs)
    for seq in _sequences(data, hashes, start, start, acceleration, 0, [0] * U32_SLOTS,
                          0xFFFFFFFF):
        op = len(run.out)
        _put_group(run.out, data, seq)
        if len(run.records) < keep:
            run.records.append((seq[1], seq[2], seq[3], op))
            run.handoff = check.step(run.records)
            if run.handoff is not None:
                break
    return run


def _op_at(run: _Run, e: int) -> int:
    """The output offset of ``run``'s sequence that starts at ``e``: from
    its records, or past them by walking its tokens from the last one."""
    recs, first = run.records, run.first
    for i, rec in enumerate(recs):
        if _start(recs, i, first) == e:
            return rec[3]
    pos, op = _start(recs, len(recs) - 1, first), recs[-1][3]
    out = run.out
    while pos < e:
        token = out[op]
        op += 1
        lit = token >> 4
        if lit == 0xF:
            while out[op] == 0xFF:
                lit += 0xFF
                op += 1
            lit += out[op]
            op += 1
        op += lit + 2
        ml = token & 0xF
        if ml == 0xF:
            while out[op] == 0xFF:
                ml += 0xFF
                op += 1
            ml += out[op]
            op += 1
        pos += lit + ml + MINMATCH
    if pos != e:
        raise AssertionError(f"no sequence starts at {e}")
    return op


def stitch_pieces(runs):
    """The row's proven pieces in order, ``(segment, first byte, end
    byte)`` of each one's output, and the hand-offs that went to the next
    segment.  Segment 0 is exact from 0; a hand-off at ``h`` continues in
    its target from ``h``.  One that lies before the point the row entered
    its segment (``h < e``) is a chain: the target agrees with that
    segment from ``h`` on, so the row goes on in the target from ``e``."""
    pieces, hops = [], 0
    k, e, e_op = 0, 0, 0
    while True:
        hand = runs[k].handoff
        if hand is not None and hand[1] < e:
            hops += hand[0] == k + 1
            k, e_op = hand[0], None
            continue
        if e_op is None:
            e_op = _op_at(runs[k], e)
        if hand is None:
            pieces.append((k, e_op, len(runs[k].out)))
            return pieces, hops
        tgt, h, own_op, tgt_op = hand
        pieces.append((k, e_op, own_op))
        hops += tgt == k + 1
        k, e, e_op = tgt, h, tgt_op


def parse_split_plain(data: bytes, cap: int, acceleration: int, seam: int, out_capacity: int):
    """One independent row's greedy parse cut at seams ``seam`` apart, by
    the split kernel's steps: every segment's run (later segments first,
    so a check never waits), the stitch of the proven pieces.  Returns
    (payload, length, status, seams, takeovers): the payload is empty and
    the status ``STATUS_INCOMPRESSIBLE`` where the length passes the cap,
    and takeovers count the seams whose hand-off did not come from the
    segment before."""
    n = len(data)
    n_segments = segments(n, seam)
    hashes = hash_all_u32(data).tolist()
    runs = [None] * n_segments
    for k in reversed(range(n_segments)):
        runs[k] = _split_run(data, hashes, k, n_segments, seam, acceleration, runs)
    pieces, hops = stitch_pieces(runs)
    total = sum(b - a for _, a, b in pieces)
    limit = out_capacity if cap < 0 else min(cap, out_capacity)
    seams = n_segments - 1
    if total > limit:
        return b"", total, STATUS_INCOMPRESSIBLE, seams, seams - hops
    payload = b"".join(bytes(runs[k].out[a:b]) for k, a, b in pieces)
    return payload, total, STATUS_OK, seams, seams - hops


def compress_split_plain(data, n, cap, accel, seam: int, out_capacity: int):
    """Plain version of the split launch on CPU tensors (see
    ``compress_split``)."""
    n_rows = data.shape[0]
    rows = data.numpy()
    out = torch.zeros((n_rows, out_capacity), dtype=torch.uint8)
    meta = torch.zeros((4, n_rows), dtype=torch.int32)
    for i, (size, c, a) in enumerate(zip(n.tolist(), cap.tolist(), accel.tolist())):
        payload, total, st, seams, taken = parse_split_plain(
            rows[i, :size].tobytes(), c, a, seam, out_capacity)
        out.numpy()[i, : len(payload)] = np.frombuffer(payload, np.uint8)
        meta[:, i] = torch.tensor([total, st, seams, taken], dtype=torch.int32)
    return out, meta[0], meta[1], meta[2:]


def compress_split(data, n, cap, accel, seam: int, plan: SplitPlan, out_capacity: int):
    """Independent rows (no prefix, cursor 0, no table carried) through
    the split parse: the CUDA kernels for CUDA tensors, the plain version
    for CPU tensors.  ``plan`` is ``split_plan(n, seam)``, its arrays on
    ``data``'s device.  Returns ``out``, ``out_len``, ``status`` and
    ``counts`` (2, N) int32: each row's seams and the seams taken over.
    ``out`` and ``status`` are ``compress_batch``'s; ``out_len`` is the
    stitched length, which passes the cap exactly where the row is
    ``STATUS_INCOMPRESSIBLE`` (its row then stays zero)."""
    if data.is_cuda:
        return _compress_split_cuda(data, n, cap, accel, seam, plan, out_capacity)
    return compress_split_plain(data, n, cap, accel, seam, out_capacity)


def _compress_split_cuda(data, n, cap, accel, seam, plan, out_capacity):
    lib = build.load()
    n_rows = data.shape[0]
    n_warps = plan.warps.shape[0]
    # the output rows and every warp's published record count, zeroed in
    # one fill
    zeros = torch.zeros(n_rows * out_capacity + 4 * n_warps, dtype=torch.uint8,
                        device=data.device)
    out = zeros[: n_rows * out_capacity].view(n_rows, out_capacity)
    progress = zeros[n_rows * out_capacity :].view(torch.int32)
    scratch = torch.empty(RECORD_BYTES * (plan.records + DEFERRED_RUNS * n_warps)
                          + plan.scratch_bytes, dtype=torch.uint8, device=data.device)
    handoff = torch.empty((n_warps, 8), dtype=torch.int32, device=data.device)
    meta = torch.empty((4, n_rows), dtype=torch.int32, device=data.device)
    with torch.cuda.device(data.device):
        h = SPLIT_KERNEL.begin()
        rc = lib.lz4t_compress_split(
            data.data_ptr(), data.stride(0), n.data_ptr(), cap.data_ptr(), accel.data_ptr(),
            plan.warps.data_ptr(), plan.row_first.data_ptr(), n_warps, n_rows, seam,
            scratch.data_ptr(), RECORD_BYTES * plan.records, progress.data_ptr(),
            handoff.data_ptr(), out.data_ptr(), out_capacity, meta.data_ptr(),
            stream_handle(),
        )
        SPLIT_KERNEL.end(h)
    build.check(rc, "compress_split")
    return out, meta[0], meta[1], meta[2:]


# ---------------------------------------------------------------------------
# host APIs
# ---------------------------------------------------------------------------


def compress_blocks(
    datas,
    cursors=None,
    tables=None,
    acceleration: int = 1,
    caps=None,
    prime_prefix=False,
    device=None,
):
    """Compress a batch of raw blocks (each entry may carry its own window
    prefix via ``cursors`` and a primed ``tables`` entry).

    Returns ``(outputs, tables)`` where ``outputs[i]`` is the compressed
    bytes or ``None`` if block ``i`` exceeded its cap (incompressible),
    and ``tables`` are the post-parse encoder tables, written back into
    the given table objects even on abort.
    """
    dev = resolve_device(device)
    n_blocks = len(datas)
    if n_blocks == 0:
        return [], []
    datas = [bytes(d) for d in datas]
    cursors = [0] * n_blocks if cursors is None else list(cursors)
    caps = [None] * n_blocks if caps is None else list(caps)
    if tables is None:
        tables = [U32Table() for _ in range(n_blocks)]
    width = round_up(max(max(len(d) for d in datas), 16), 16)
    tbl, offs = tables_from_jax(tables)
    params = np.array([[len(d) for d in datas], cursors,
                       [-1 if c is None else int(c) for c in caps],
                       [max(int(acceleration), 1)] * n_blocks, offs.numpy(),
                       [1 if prime_prefix else 0] * n_blocks], np.int64).astype(np.int32)
    (rows, _), params, tbl = hostpack.upload(dev, hostpack.Rows(datas, width=width), params, tbl)
    handle = hostpack.Handle(*compress_batch(rows, *params, tbl,
                                             round_up(compress_bound(width), 16)))
    out_len, status, table_np = handle.meta()
    stored = status == STATUS_INCOMPRESSIBLE
    table_np = table_np.view(np.uint32)
    rows = handle.collect(out_len, ~stored)
    outputs = []
    for i in range(n_blocks):
        tables[i].dict[:] = table_np[i].astype(tables[i].dict.dtype)
        outputs.append(None if stored[i] else bytes(rows[i]))
    return outputs, tables


def compress_block_cuda(
    data,
    cursor: int = 0,
    table=None,
    out=None,
    acceleration: int = 1,
    cap: int | None = None,
    device=None,
):
    """Single-block engine adapter; the same contract as the reference
    spec's ``compress_block``.  The CUDA kernel keeps no on-chip window of
    the block, so 4 MiB blocks take the same kernel."""
    data = bytes(data)
    if table is None:
        table = U16Table() if len(data) <= 0xFFFF else U32Table()
    if len(data) > table.payload_size_limit:
        raise BlockTooBig(
            f"input of {len(data)} bytes exceeds table limit {table.payload_size_limit}"
        )
    outputs, _ = compress_blocks(
        [data], [cursor], [table], acceleration=acceleration, caps=[cap], device=device
    )
    if outputs[0] is None:
        raise Incompressible()
    if out is not None:
        out.extend(outputs[0])
        return out
    return outputs[0]
