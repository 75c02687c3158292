"""Lane compressor: the CUDA kernel, its plain versions, and the host API.

Counterpart of ``lz4tpu/kernels/compress128.py``.  Each row is
``[window | block]`` bytes of one flat source tensor: the block (at most
``MAX_B`` = 32 KiB) is parsed from ``cur0``, behind a window of at most
64 KiB that matches may reach into.  One thread block compresses one row
(``csrc/compress128.cu``).  Any number of rows goes into one launch (the
TPU's 128 is its vector width, not part of the contract).

Three modes, each with its plain version here:

* default — a parse defined so that most of it runs in parallel: every
  position's candidates are found before the walk, off its chain
  (``lane_records_plain``: the latest positions of the position's bucket,
  ``WAYS`` of them before its group of ``GROUP`` positions and one inside
  it, compared forward to ``CAP`` bytes), then one walk takes the first
  position with a record of 4 bytes or more (the best of ``LAZY`` from
  there), extends the match forward to ``n - 5`` and backward into the
  pending literals as far as the bytes match, and jumps to its end
  (``lane_parse_plain``).  In the kernel, eight warps find the candidates
  of the next ``TILE`` positions and emit the sequences the walk found in
  the tile before while one warp walks.  The output is valid LZ4 no
  larger than the greedy parse's on real data, not its bytes, and not
  ``lz4tpu``'s bytes either (its lane kernel probes serially);
* window — ``cur0 > 0``: every window position goes into the table first
  (in the kernel, on the device), candidates may lie in the window,
  offsets are capped at 0xFFFF;
* STRICT — byte parity with the reference greedy parse (the scalar
  compressor, ``kernels/compress.py``) for rows without a window at
  ``hashlog`` 12: the 5-byte hash picks the bucket, an empty slot reads as
  position 0, the skip schedule, the unbounded backward extension and the
  ``cursor - 2`` re-insert are the reference's; the 15-bit tag only saves
  the byte compare where it cannot succeed.  One lane of one warp searches.

``prime_tables_packed`` is the JAX package's window priming (every 3rd
position, one way), kept as the port's equal of ``lz4tpu``'s lane tables.

Tensor contract of ``compress128`` (kernel and plain version alike):

* ``src`` (L,) uint8 — the flat source all rows are cut from;
* ``base`` (N,) int64 — row i is ``src[base[i] : base[i] + n[i]]``; every
  byte of a row is valid window or block (a caller cuts a window short by
  moving ``base`` up, not by masking);
* ``n`` (N,) int32 row lengths, ``cur0`` (N,) int32 parse starts;
* returns ``out`` (N, W) uint8 (zero past ``out_len``), ``out_len``, and
  ``tail_pos``/``tail_lit`` (N,) int32: where the stream's last token sits
  and how many literals follow it, which is what a splice needs
  (``kernels/splice.py``).  ``W`` is the worst case of the longest block,
  so there is no failure status.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import build, hostpack
from ..runtime import KernelStats, resolve_device, round_up, stream_handle
from ..spec.block import WINDOW_SIZE, compress_bound
from ..spec.table import U32_SLOTS
from ..state import LANE_SENTINEL
from .compress import _lcp, _lsic, parse_plain
from .splice import tail_split
from .status import STATUS_OK

KERNEL = KernelStats("compress128")
SOURCE = "lz4tpu_torch/csrc/compress128.cu"
REPLACES = "lz4tpu/kernels/compress128.py:156"

HASHLOG = 12  # buckets: 1 << HASHLOG a row (the kernel's table: 64 KiB of ways)
MIN_HASHLOG = 4
TILE = 256  # positions whose records the walk sees at once (csrc/compress128.cu)
GROUP = 32  # positions of a group of the candidate pass: a warp's
WAYS = 4  # candidates a bucket keeps: its latest positions
CAP = 32  # bytes the candidate pass compares; the walk extends a match past it
LAZY = 4  # positions from the first hit on among which the walk picks a match
BACK_SEEN = 7  # equal bytes before a position a record of the kernel carries
MAX_B = 32 << 10  # block bytes a row may hold: 17-bit positions cover 96 KiB
HASH_MUL = 2654435761
SENTINEL = LANE_SENTINEL  # empty slot: a position no row reaches, tag 0

_TAG_MASK = 0x7FFF


def _check(src, base, n, cur0, hashlog, strict):
    if src.dtype != torch.uint8 or src.dim() != 1 or not src.is_contiguous():
        raise ValueError("compress128: src must be a contiguous (L,) uint8 tensor")
    n_rows = n.shape[0] if n.dim() == 1 else -1
    for name, t, dtype in (("base", base, torch.int64), ("n", n, torch.int32),
                           ("cur0", cur0, torch.int32)):
        if t.dtype != dtype or t.shape != (n_rows,) or not t.is_contiguous():
            raise ValueError(f"compress128: {name} must be a contiguous (N,) {dtype} tensor")
        if t.device != src.device:
            raise ValueError(f"compress128: {name} is on {t.device}, src on {src.device}")
    if not MIN_HASHLOG <= int(hashlog) <= HASHLOG:
        raise ValueError(f"compress128: hashlog must be {MIN_HASHLOG}..{HASHLOG}")
    if strict and int(hashlog) != HASHLOG:
        raise ValueError("compress128: strict parity is defined for hashlog 12")
    if src.device.type not in ("cuda", "cpu"):
        raise ValueError(f"compress128: unsupported device {src.device}")
    if n_rows == 0:
        return 0
    # the rows' values, checked where they lie: the kernel reads src through
    # them and has no bounds checks of its own
    block = n - cur0
    bad = (
        (cur0 < 0) | (cur0 > WINDOW_SIZE) | (block < 0) | (block > MAX_B)
        | (base < 0) | (base + n > src.numel())
    )
    if strict:
        bad = bad | (cur0 != 0)
    n_bad, longest = torch.stack([bad.sum(), block.max().to(torch.int64)]).tolist()
    if n_bad:
        raise ValueError(
            f"compress128: {n_bad} rows out of range (row inside src, block <= {MAX_B}, "
            f"window <= {WINDOW_SIZE}" + (", no window in strict mode)" if strict else ")")
        )
    return int(longest)


def compress128(src, base, n, cur0, *, hashlog=HASHLOG, strict=False):
    """Compress a batch of rows; the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (see the module docstring)."""
    longest = _check(src, base, n, cur0, hashlog, strict)
    out_capacity = round_up(compress_bound(longest), 16)
    if src.is_cuda:
        return _compress128_cuda(src, base, n, cur0, int(hashlog), bool(strict), out_capacity)
    return compress128_plain(src, base, n, cur0, int(hashlog), bool(strict), out_capacity)


def _compress128_cuda(src, base, n, cur0, hashlog, strict, out_capacity):
    lib = build.load()
    n_rows = n.shape[0]
    out = torch.zeros((n_rows, out_capacity), dtype=torch.uint8, device=src.device)
    out_len = torch.zeros(n_rows, dtype=torch.int32, device=src.device)
    tail_pos = torch.zeros(n_rows, dtype=torch.int32, device=src.device)
    tail_lit = torch.zeros(n_rows, dtype=torch.int32, device=src.device)
    if n_rows == 0:
        return out, out_len, tail_pos, tail_lit
    with torch.cuda.device(src.device):
        h = KERNEL.begin()
        rc = lib.lz4t_compress128(
            src.data_ptr(), base.data_ptr(), n.data_ptr(), cur0.data_ptr(), out.data_ptr(),
            out_capacity, out_len.data_ptr(), tail_pos.data_ptr(), tail_lit.data_ptr(),
            n_rows, hashlog, int(strict), stream_handle(),
        )
        KERNEL.end(h)
    build.check(rc, "compress128")
    return out, out_len, tail_pos, tail_lit


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _hash_vm(row: bytes):
    """The 4-byte word at every position that has one, times HASH_MUL."""
    buf = np.frombuffer(row, np.uint8).astype(np.uint32)
    if len(buf) < 4:
        return np.zeros(0, np.uint32)
    v = buf[:-3] | (buf[1:-2] << 8) | (buf[2:-1] << 16) | (buf[3:] << 24)
    return v * np.uint32(HASH_MUL)  # wraps to 32 bits


def _hash_words(row: bytes, hashlog: int):
    """Bucket and tag of the 4-byte word at every position that has one."""
    vm = _hash_vm(row)
    return vm >> np.uint32(32 - hashlog), (vm >> np.uint32(6)) & np.uint32(_TAG_MASK)


def prime_tables_packed(prefixes, hashlog: int = HASHLOG) -> torch.Tensor:
    """Window priming, the plain reference of what the kernel does on the
    device: every 3rd position of a window from 0 to ``len - 12`` as a
    packed ``pos17 | tag15 << 17`` entry in row coordinates, later
    positions overwriting earlier ones; windows under 16 bytes (and
    ``None``) leave the sentinel.  Returns (N, 1 << hashlog) int32."""
    tables = np.full((len(prefixes), 1 << hashlog), SENTINEL, np.uint32)
    for i, p in enumerate(prefixes):
        if p is None or len(p) < 16:
            continue
        bucket, tag = _hash_words(bytes(p), hashlog)
        pos = np.arange(0, len(p) - 12 + 1, 3, dtype=np.int64)
        # fancy assignment keeps the last of equal indices: insertion order
        tables[i, bucket[pos]] = pos.astype(np.uint32) | (tag[pos] << np.uint32(17))
    return torch.from_numpy(tables.view(np.int32))


def _emit(out: bytearray, row: bytes, anchor: int, mstart: int, offset: int, mlen: int) -> None:
    """One sequence: token, literal LSIC, literals, offset, match LSIC."""
    lit = mstart - anchor
    extra = mlen - 4
    out.append((min(lit, 0xF) << 4) | min(extra, 0xF))
    _lsic(out, lit)
    out += row[anchor:mstart]
    out.append(offset & 0xFF)
    out.append(offset >> 8)
    _lsic(out, extra)


def lane_records_plain(row: bytes, cur0: int = 0, hashlog: int = HASHLOG):
    """The candidate pass of default and window mode, for every block
    position p that may start a match (``cur0 <= p <= n - 12``).

    The row is cut into groups of ``GROUP`` positions in row coordinates,
    and every position with a 4-byte word is inserted, window and block
    alike.  p's candidates are the latest position before p inside p's
    group whose word lands in p's bucket, and the ``WAYS`` latest such
    positions before p's group.  Each candidate r with ``p - r <= 0xFFFF``
    is compared with p forward, to at most ``CAP`` bytes and to ``n - 5``;
    the record is the longest compare, the first in that order on a tie,
    kept if it reaches 4 bytes.  Returns (length, offset) arrays indexed by
    ``p - cur0``, length 0 where there is no record."""
    n = len(row)
    lo, hi = cur0, n - 11
    if hi <= lo:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    bucket = _hash_words(row, hashlog)[0].astype(np.int64)
    pos = np.arange(lo, hi, dtype=np.int64)
    # the positions sorted by (bucket, position): p's latest same-bucket
    # predecessor is the entry before p's, and the latest before p's group
    # the entry before the run of p's (bucket, group)
    order = np.argsort(bucket.astype(np.uint16), kind="stable")  # a radix sort
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    sb, sg = bucket[order], order // GROUP
    boundary = np.ones(len(order), bool)
    boundary[1:] = (sb[1:] != sb[:-1]) | (sg[1:] != sg[:-1])
    run_start = np.maximum.accumulate(np.where(boundary, np.arange(len(order)), 0))
    j = rank[pos]
    newest = run_start[j] - 1
    before = j - 1
    # 8 bytes from every position (zeros past the row), compared a word at
    # a time; a compare stops at its first differing byte
    pad = np.frombuffer(row + bytes(CAP + 8), np.uint8).astype(np.uint64)
    words = np.zeros(n + CAP, np.uint64)
    for i in range(8):
        words |= pad[i : i + n + CAP] << np.uint64(8 * i)
    # every candidate at once: the in-group predecessor first, then the ways
    # from the newest (the first of the longest compares wins)
    at = np.stack([np.where(before > newest, before, -1)] + [newest - w for w in range(WAYS)])
    cand = order[np.maximum(at, 0)]
    ok = (at >= 0) & (bucket[cand] == bucket[pos]) & (pos - cand <= 0xFFFF)
    pair = np.flatnonzero(ok)
    mine, theirs = np.broadcast_to(pos, at.shape).ravel()[pair], cand.ravel()[pair]
    got = np.full(len(pair), CAP, np.int64)
    going = np.arange(len(pair))  # compares not yet stopped
    for k in range(0, CAP, 8):
        x = words[mine[going] + k] ^ words[theirs[going] + k]
        stop = x != 0
        low = x[stop] & (~x[stop] + np.uint64(1))  # the lowest differing bit
        got[going[stop]] = k + (np.log2(low.astype(np.float64)).astype(np.int64) >> 3)
        going = going[~stop]
    lengths = np.zeros(at.shape, np.int64)
    lengths.ravel()[pair] = np.minimum(got, np.minimum(CAP, n - 5 - mine))
    best = np.argmax(lengths, axis=0)
    length = lengths[best, np.arange(len(pos))]
    offset = pos - cand[best, np.arange(len(pos))]
    offset[length < 4] = 0
    length[length < 4] = 0
    return length, offset


def lane_parse_plain(row: bytes, cur0: int = 0, hashlog: int = HASHLOG):
    """One row's default/window-mode parse, the kernel's steps in Python:
    the candidate pass (``lane_records_plain``), then the walk.  The first
    position q at or after the cursor with a record opens the next match;
    of q and the ``LAZY - 1`` positions after it inside q's tile, the one
    whose record is longest less its distance from q is taken (the first
    such).  The match is extended forward past ``CAP`` to ``n - 5`` and
    backward into the pending literals (to the anchor and the row's first
    byte), and the cursor jumps to its end.  Returns (stream, tail_pos,
    tail_lit)."""
    n = len(row)
    length, offset = lane_records_plain(row, cur0, hashlog)
    # the first position with a record at or after each position
    at = np.where(length > 0, np.arange(len(length)), len(length))
    first_hit = (np.minimum.accumulate(at[::-1])[::-1] + cur0).tolist()
    length, offset = length.tolist(), offset.tolist()
    out = bytearray()
    anchor = cur0
    while anchor - cur0 < len(length):
        first = first_hit[anchor - cur0]
        if first - cur0 == len(length):
            break
        q, best = first, -1
        for p in range(first, min(first + LAZY, (first // TILE + 1) * TILE, n - 11)):
            if length[p - cur0] and length[p - cur0] - (p - first) > best:
                q, best = p, length[p - cur0] - (p - first)
        mlen, off = length[q - cur0], offset[q - cur0]
        c = q - off
        if mlen == CAP:
            mlen = _lcp(row, q, n - 5, c, n)
        bt = 0
        max_bt = min(q - anchor, c)
        while bt < max_bt and row[q - bt - 1] == row[c - bt - 1]:
            bt += 1
        _emit(out, row, anchor, q - bt, off, mlen + bt)
        anchor = q + mlen
    tail_pos = len(out)
    lit = n - anchor
    out.append(min(lit, 0xF) << 4)
    _lsic(out, lit)
    out += row[anchor:]
    return bytes(out), tail_pos, lit


def lane_parse_tiled_plain(row: bytes, cur0: int = 0, hashlog: int = HASHLOG):
    """A model of ``csrc/compress128.cu``'s steps in default and window
    mode, for the tests (``lane_parse_plain`` is the specification): the
    window primed in ``WAYS`` rounds (round w takes the latest position below
    way w - 1's), then tile by tile the groups' in-group ranks and
    predecessors, their turns at the ways, the records of the tile (back
    bytes << 24 | length << 16 | offset) and the walk's jumps, and the walk
    from jump to jump with its cursor kept across tiles.
    Returns (stream, tail_pos, tail_lit)."""
    n = len(row)
    buf = np.frombuffer(row, np.uint8)
    vm = _hash_vm(row)
    bucket = (vm >> np.uint32(32 - hashlog)).astype(np.int64)
    tag = ((vm >> np.uint32(6)) & np.uint32(_TAG_MASK)).astype(np.int64)
    ways = np.zeros((1 << hashlog, WAYS), np.int64)  # position + 1, 0 empty
    t0 = cur0 // TILE * TILE
    window = np.arange(min(t0, n - 3))
    for w in range(WAYS):
        above = ways[bucket[window], w - 1] if w else np.full(len(window), n + 1)
        take = window[window < above - 1] if w else window
        np.maximum.at(ways[:, w], bucket[take], take + 1)

    def compare(p, c, span):
        m = 0
        while m < span and buf[p + m] == buf[c + m]:
            m += 1
        return m

    def records(ts):
        rec = [0] * TILE
        for g in range(TILE // GROUP):
            base = ts + g * GROUP
            lanes = [p for p in range(base, base + GROUP) if p + 4 <= n]
            old = {p: ways[bucket[p]].copy() for p in lanes}
            for p in lanes:  # this group's turn: the newest WAYS, then the old shifted
                same = [q for q in lanes if bucket[q] == bucket[p]]
                if p == same[-1]:
                    newest = same[::-1][:WAYS]
                    ways[bucket[p]] = ([q + 1 for q in newest] + list(old[p]))[:WAYS]
            for p in lanes:
                if not (p >= cur0 and p + 12 <= n):
                    continue
                span = min(CAP, n - 5 - p)
                below = [q for q in lanes if q < p and bucket[q] == bucket[p]]
                cands = below[-1:] + [int(e) - 1 for e in old[p]
                                      if e and tag[int(e) - 1] == tag[p] and p - (e - 1) <= 0xFFFF]
                best = best_off = 0
                for c in cands:
                    got = compare(p, c, span)
                    if got > best:
                        best, best_off = got, p - c
                if best >= 4:  # and the equal bytes before, up to BACK_SEEN
                    c = p - best_off
                    back = 0
                    while back < BACK_SEEN and back < c and buf[p - 1 - back] == buf[c - 1 - back]:
                        back += 1
                    rec[p - ts] = (back << 24) | (best << 16) | best_off
        return rec

    out = bytearray()
    anchor = cur = cur0
    tiles = max(1, -(-(n - t0) // TILE))
    for k in range(tiles):
        ts = t0 + k * TILE
        rec = records(ts)
        lim = min(ts + TILE, n - 11)
        # the jumps: from a record, the lazy step to the one taken; from any
        # position, the first record at or after it
        pick = {}
        for i in range(TILE):
            if rec[i]:
                steps = [((rec[i + d] >> 16) & 0xFF) - d if i + d < TILE and rec[i + d] else -1
                         for d in range(LAZY)]
                pick[i] = steps.index(max(steps))
        jump, nxt = [TILE] * TILE, TILE
        for i in reversed(range(TILE)):
            nxt = i if rec[i] else nxt
            jump[i] = nxt + pick[nxt] if nxt < TILE else TILE
        while cur < lim:
            q = ts + jump[cur - ts]
            if q >= lim:
                cur = lim
                break
            m, off = (rec[q - ts] >> 16) & 0xFF, rec[q - ts] & 0xFFFF
            c = q - off
            if m == CAP:
                m += compare(q + CAP, c + CAP, n - 5 - q - CAP)
            max_bt = min(q - anchor, c)
            bt = min(rec[q - ts] >> 24, max_bt)
            if bt == BACK_SEEN:
                while bt < max_bt and buf[q - bt - 1] == buf[c - bt - 1]:
                    bt += 1
            _emit(out, row, anchor, q - bt, off, m + bt)
            anchor = cur = q + m
    tail_pos = len(out)
    lit = n - anchor
    out.append(min(lit, 0xF) << 4)
    _lsic(out, lit)
    out += row[anchor:]
    return bytes(out), tail_pos, lit


def strict_parse_plain(row: bytes):
    """One row's STRICT parse: the reference greedy parse with a fresh U32
    table at acceleration 1.  Returns (stream, tail_pos, tail_lit)."""
    stream, status = parse_plain(row, 0, -1, 1, 0, False, [0] * U32_SLOTS, False,
                                 compress_bound(len(row)))
    if status != STATUS_OK:
        raise RuntimeError("compress128: an uncapped parse aborted")
    if not stream:  # the reference writes nothing for no input
        return b"\x00", 0, 0
    return (stream, *tail_split(stream))


def compress128_plain(src, base, n, cur0, hashlog, strict, out_capacity):
    """Plain version of the kernel on CPU tensors (same contract)."""
    n_rows = n.shape[0]
    flat = src.numpy()
    out = torch.zeros((n_rows, out_capacity), dtype=torch.uint8)
    out_np = out.numpy()
    meta = np.zeros((3, n_rows), np.int32)
    for i, (b, ln, c0) in enumerate(zip(base.tolist(), n.tolist(), cur0.tolist())):
        row = flat[b : b + ln].tobytes()
        stream, tpos, tlit = strict_parse_plain(row) if strict else lane_parse_plain(row, c0, hashlog)
        out_np[i, : len(stream)] = np.frombuffer(stream, np.uint8)
        meta[:, i] = len(stream), tpos, tlit
    out_len, tail_pos, tail_lit = (torch.from_numpy(m.copy()) for m in meta)
    return out, out_len, tail_pos, tail_lit


# ---------------------------------------------------------------------------
# host API
# ---------------------------------------------------------------------------


def pack_lane_rows(blocks, prefixes=None):
    """Blocks (and their windows) -> the flat source and row scalars of
    ``compress128`` as numpy arrays: rows ``[prefix's last 64 KiB | block]``
    laid end to end."""
    n_rows = len(blocks)
    if prefixes is None:
        prefixes = [b""] * n_rows
    if len(prefixes) != n_rows:
        raise ValueError(f"{len(prefixes)} prefixes for {n_rows} blocks")
    rows = []
    cur0 = np.zeros(n_rows, np.int32)
    for i, (b, p) in enumerate(zip(blocks, prefixes)):
        b = bytes(b)
        if len(b) > MAX_B:
            raise ValueError(f"compress128: block {i} has {len(b)} bytes, over {MAX_B}")
        p = bytes(p or b"")[-WINDOW_SIZE:]
        cur0[i] = len(p)
        rows.append(p + b)
    n = np.array([len(r) for r in rows], np.int32)
    base = np.cumsum(n, dtype=np.int64) - n
    flat = np.frombuffer(b"".join(rows), np.uint8)
    return flat, base, n, cur0


def compress_blocks_128(blocks, *, hashlog=None, prefixes=None, strict=False, device=None):
    """Compress raw blocks (each at most 32 KiB) with the lane compressor,
    any number of them in one launch; returns a list of LZ4 block byte
    strings (``b"\\x00"`` for an empty block).

    ``prefixes`` (optional, one per block): window or dictionary bytes (the
    last 64 KiB count) that the block's matches may reach back into; a
    decoder needs the same bytes as its prefix.  ``strict=True`` gives the
    reference greedy parse's bytes (no prefixes, ``hashlog`` 12)."""
    dev = resolve_device(device)
    if len(blocks) == 0:
        return []
    if strict and prefixes is not None and any(prefixes):
        raise ValueError("compress128: strict parity covers blocks without a window")
    handle = hostpack.Handle(*compress128(
        *hostpack.upload(dev, *pack_lane_rows(blocks, prefixes)),
        hashlog=HASHLOG if hashlog is None else hashlog,
        strict=strict,
    ))
    return [bytes(row) for row in handle.collect(handle.meta()[0])]
