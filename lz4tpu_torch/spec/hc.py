"""High-compression LZ4 parse: hash-chain match finder with lazy matching.

The port's own copy of ``lz4tpu/spec/hc.py``, byte for byte the same
output.  It runs on the host, as in the JAX package, which has no device
kernel for it either: ``CompressionSettings.level()`` compresses each
block with the greedy parse (on the device) and with this one, and keeps
the smaller payload.

* every position inserts into ``head[hash4] -> pos`` / ``prev[pos] ->
  older pos`` chains (no skip acceleration: ratio over speed);
* at each position up to ``attempts(level)`` chain candidates are walked;
  the longest match wins, ties prefer the smaller offset;
* matches extend backward into pending literals (like the greedy
  backtrack) and forward at most to ``n-5`` (the last-5 rule); new matches
  start only at ``cursor <= n-12`` (the last-12 rule), so the output
  decodes with any conforming decoder;
* lazy matching: at levels >= 3, if the *next* position holds a strictly
  longer match, the current position is emitted as a literal instead.

Levels map to search depth: ``attempts = 1 << (level - 1)`` capped at
16384.  The prefix (dictionary / linked-block carry-over window) is handled
by inserting every prefix position into the chains before parsing.
"""

from __future__ import annotations

import numpy as np

from .block import LAST_LITERALS, MFLIMIT, MINMATCH, Incompressible, _write_lsic_tail

HASH_LOG_HC = 15
_HASH_MUL = 2654435761
WINDOW = 0xFFFF


def _hash4(data: bytes, pos: int) -> int:
    v = int.from_bytes(data[pos : pos + 4], "little")
    return ((v * _HASH_MUL) & 0xFFFFFFFF) >> (32 - HASH_LOG_HC)


def attempts_for_level(level: int) -> int:
    return min(1 << (max(level, 2) - 1), 16384)


class HCState:
    """Hash-chain state: ``head[hash] -> last pos + 1`` (0 = empty),
    ``prev[pos] -> previous pos + 1`` with the same hash (0 = end)."""

    def __init__(self, capacity: int):
        self.head = np.zeros(1 << HASH_LOG_HC, np.int64)
        self.prev = np.zeros(capacity, np.int64)

    def insert(self, data: bytes, pos: int) -> None:
        h = _hash4(data, pos)
        self.prev[pos] = self.head[h]
        self.head[h] = pos + 1


def _match_len(data: bytes, a: int, b: int, limit: int) -> int:
    """Length of the common run data[a..] == data[b..], capped at limit-a."""
    n = 0
    m = limit - a
    while n < m and data[a + n] == data[b + n]:
        n += 1
    return n


def compress_block_hc(
    data,
    cursor: int = 0,
    out: bytearray | None = None,
    level: int = 9,
    cap: int | None = None,
) -> bytearray:
    """HC parse of ``data[cursor:]``; ``data[:cursor]`` is the prefix
    (dictionary / carry-over window) whose positions seed the chains."""
    data = bytes(data)
    if out is None:
        out = bytearray()
    n = len(data)
    if cursor >= n:
        return out

    state = HCState(n)
    hi = 0  # insert high-water mark: positions [0, hi) are in the chains

    def insert_up_to(q: int) -> None:
        nonlocal hi
        q = min(q, n - (MINMATCH - 1))
        while hi < q:
            state.insert(data, hi)
            hi += 1

    insert_up_to(cursor)

    nb_attempts = attempts_for_level(level)
    lazy = level >= 3

    def find_best(pos: int, literal_start: int):
        """Longest match at ``pos`` (with backward extension into pending
        literals); returns (length_inc_backtrack, offset, backtrack)."""
        if pos > n - LAST_LITERALS:
            return 0, 0, 0
        best_len, best_off, best_bt = 0, 0, 0
        # `pos` itself is already in the chains (the head entry): start the
        # walk at its predecessor so we never self-match
        cand = int(state.prev[pos]) - 1
        tries = nb_attempts
        max_bt = pos - literal_start
        while cand >= 0 and tries > 0:
            off = pos - cand
            if off > WINDOW:
                break  # chain is ordered newest-first; all older are farther
            fwd = _match_len(data, pos, cand, n - MFLIMIT)
            if fwd >= MINMATCH:
                bt = 0
                while (
                    bt < max_bt
                    and cand - bt > 0
                    and data[pos - bt - 1] == data[cand - bt - 1]
                ):
                    bt += 1
                total = fwd + bt
                if total > best_len:
                    best_len, best_off, best_bt = total, off, bt
            cand = int(state.prev[cand]) - 1
            tries -= 1
        if best_len - best_bt < MINMATCH:
            return 0, 0, 0
        return best_len, best_off, best_bt

    def emit(literal_start: int, literal_end: int, offset: int, extra: int):
        literal_len = literal_end - literal_start
        group = bytearray()
        group.append((min(literal_len, 0xF) << 4) | min(extra, 0xF))
        _write_lsic_tail(group, literal_len)
        group.extend(data[literal_start:literal_end])
        group.extend(offset.to_bytes(2, "little"))
        _write_lsic_tail(group, extra)
        if cap is not None and len(out) + len(group) > cap:
            raise Incompressible()
        out.extend(group)

    def emit_tail(literal_start: int):
        literal_len = n - literal_start
        group = bytearray()
        group.append(min(literal_len, 0xF) << 4)
        _write_lsic_tail(group, literal_len)
        group.extend(data[literal_start:n])
        if cap is not None and len(out) + len(group) > cap:
            raise Incompressible()
        out.extend(group)

    pos = cursor
    literal_start = cursor
    while True:
        if n - pos < LAST_LITERALS:
            emit_tail(literal_start)
            return out
        insert_up_to(pos + 1)
        mlen, moff, mbt = find_best(pos, literal_start)
        if mlen == 0:
            pos += 1
            continue

        if lazy and pos + 1 <= n - LAST_LITERALS:
            insert_up_to(pos + 2)
            nlen, noff, nbt = find_best(pos + 1, literal_start)
            if nlen > mlen:
                # next position is strictly better: current byte stays literal
                pos += 1
                mlen, moff, mbt = nlen, noff, nbt
        start = pos - mbt
        match_fwd = mlen - mbt  # forward part from `pos`
        end = pos + match_fwd
        emit(literal_start, start, moff, mlen - MINMATCH)
        # positions covered by the match also enter the chains
        insert_up_to(end)
        pos = end
        literal_start = end
