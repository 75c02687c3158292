"""Stream splice: standalone LZ4 chunk streams joined into one valid block.

The port's own copy of ``lz4tpu.native.tail_split`` and
``lz4tpu.native.splice_streams`` (``lz4tpu/native/__init__.py:403-477``),
byte-equal to them on the same payloads.  The lane compressor parses a big
block as chunks of at most 32 KiB; the chunk streams of one output block
are spliced into ONE block of the declared size.  LZ4 is end-delimited:
every stream ends in a literal-only sequence that has no offset field, so
an interior stream's final literals fold into the next stream's first
sequence, whose literal-length header is rewritten.  Offsets stay valid
across the joins because the decoder's output is continuous.

The lane kernel knows where it put each stream's last token, so the frame
path hands ``(token position, literal count)`` pairs to ``splice_streams``
and no stream is walked again on the host; ``tail_split`` is the walk for
streams that come without them.
"""

from __future__ import annotations

from ..spec.block import DecodeError


def _literal_header(total: int, match_nibble: int) -> bytes:
    """Token and literal-length bytes of a sequence with ``total`` literals."""
    if total < 15:
        return bytes([(total << 4) | match_nibble])
    rem = total - 15
    return bytes([0xF0 | match_nibble]) + b"\xff" * (rem // 255) + bytes([rem % 255])


def tail_split(stream) -> tuple[int, int]:
    """(token position, literal count) of a raw block stream's final
    literal-only sequence (``(0, 0)`` for an empty stream); ``DecodeError``
    on a stream that is cut short or ends in a match."""
    s = bytes(stream)
    n = len(s)
    if n == 0:
        return 0, 0
    pos = 0
    bad = DecodeError(DecodeError.KIND_UNEXPECTED_END)
    while pos < n:
        token_pos = pos
        token = s[pos]
        pos += 1
        lit = token >> 4
        if lit == 15:
            while True:
                if pos >= n:
                    raise bad
                b = s[pos]
                pos += 1
                lit += b
                if b != 0xFF:
                    break
        pos += lit
        if pos > n:
            raise bad
        if pos == n:
            return token_pos, lit
        if pos + 2 > n:
            raise bad
        pos += 2
        if token & 0xF == 15:
            while True:
                if pos >= n:
                    raise bad
                b = s[pos]
                pos += 1
                if b != 0xFF:
                    break
    raise bad


def splice_streams(payloads, tails=None) -> bytes:
    """Concatenate standalone raw LZ4 streams into ONE valid stream that
    decodes to the concatenation of their outputs.  ``tails[i]``, where
    given, is stream ``i``'s ``(token position, literal count)`` of its
    final literal-only sequence (what ``tail_split`` would find)."""
    out = bytearray()
    pending = []  # literal runs of the streams whose tail is still open
    last = len(payloads) - 1
    for idx, p in enumerate(payloads):
        p = bytes(p)
        if idx < last:
            tpos, tlit = tail_split(p) if tails is None else tails[idx]
            body = p[:tpos]
            lits = p[len(p) - tlit :] if tlit else b""
        else:
            body, lits = p, b""
        if not body:
            if lits:
                pending.append(lits)
            continue
        if pending:
            token = body[0]
            lit = token >> 4
            pos = 1
            if lit == 15:
                while True:
                    b = body[pos]
                    pos += 1
                    lit += b
                    if b != 0xFF:
                        break
            total = lit + sum(map(len, pending))
            out += _literal_header(total, token & 0xF)
            for run in pending:
                out += run
            out += memoryview(body)[pos:]
        else:
            out += body
        pending = [lits] if lits else []
    if pending:
        # every stream was literal-only: one literal tail
        out += _literal_header(sum(map(len, pending)), 0)
        for run in pending:
            out += run
    return bytes(out)
