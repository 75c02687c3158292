"""The Silesia stand-in, made from a seed and from nothing on the host.

A frozen copy of the repository's Silesia stand-in generator with three
changes: the stream of every member is drawn from the run's seed as well
as from the member's name; the binary members (mozilla, ooffice) draw
their tiles from a pool of random bytes instead of from executables found
on the machine; and the noise knobs are calibrated anew for these pools.
So a seed gives the same bytes on every host, and another seed gives other
bytes of the same sizes, textures and ratios.

Each of the 12 members has the exact size of the Silesia corpus
(https://sun.aei.polsl.pl/~sdeor/index.php?page=silesia, 211,938,580 B in
all).  Its texture class and noise knob set its LZ4 ratio, calibrated to
the published per-member ratio of the lz4 1.9.x default level (the
``lz4_ratio`` column).  The stream is a Zipf-ranked concatenation of tiles
from a per-member pool, a ``knob`` share of the tile slots replaced by
fresh noise; the concatenation is gathered in bulk with NumPy.
"""

from __future__ import annotations

import hashlib

import numpy as np

#: bumped whenever the bytes of a seed change
VERSION = 1

# name, original bytes, published LZ4 default-level ratio, texture, noise
# knob (bisected so that the whole member's 4 MiB-block frame from liblz4
# lands within 0.002 of the published ratio; achieved on seeds 7 and 99)
SILESIA = [
    ("dickens", 10_192_446, 0.632, "text", 0.1750),  # 0.6324, 0.6320
    ("mozilla", 51_220_480, 0.512, "binary", 0.2234),  # 0.5136, 0.5130
    ("mr", 9_970_564, 0.546, "smooth16", 0.3672),  # 0.5453, 0.5463
    ("nci", 33_553_445, 0.164, "structured", 0.0792),  # 0.1651, 0.1652
    ("ooffice", 6_152_192, 0.705, "binary", 0.5677),  # 0.7039, 0.7071
    ("osdb", 10_085_684, 0.521, "records", 0.3616),  # 0.5194, 0.5187
    ("reymont", 6_627_202, 0.519, "text", 0.0281),  # 0.5200, 0.5196
    ("samba", 21_606_400, 0.359, "source", 0.1329),  # 0.3583, 0.3583
    ("sao", 7_251_944, 0.934, "noisyrec", 0.8810),  # 0.9341, 0.9333
    ("webster", 41_458_703, 0.489, "text", 0.0120),  # 0.4908, 0.4908
    ("x-ray", 8_474_240, 0.991, "noise", 0.9619),  # 0.9927, 0.9930
    ("xml", 5_345_280, 0.224, "structured", 0.1491),  # 0.2231, 0.2227
]

NAMES = [n for n, *_ in SILESIA]
TOTAL_BYTES = sum(s for _, s, *_ in SILESIA)  # 211,938,580


def _rng(*key) -> np.random.Generator:
    h = hashlib.sha256(":".join(map(str, ("lz4bench-silesia", VERSION, *key))).encode())
    return np.random.default_rng(int.from_bytes(h.digest()[:8], "little"))


def _tile_pool(klass: str, rng: np.random.Generator) -> list[bytes]:
    """The member's pool of tiles; a tile drawn again is what LZ4 sees as a
    match, so the tiles' lengths set the profile of match lengths."""
    pool = []
    if klass in ("text", "source"):
        letters = np.frombuffer(b"etaoinshrdlucmfwypvbgkqjxz    \n", dtype=np.uint8)
        n_tiles, lo, hi = (1400, 4, 12) if klass == "text" else (700, 8, 40)
        for _ in range(n_tiles):
            ln = int(rng.integers(lo, hi))
            pool.append(letters[rng.integers(0, len(letters), ln)].tobytes())
        if klass == "source":
            pool += [
                b"\treturn ret;\n", b"static int ", b"#include <", b"();\n}\n\n",
                b"struct ", b"const char *", b"if (err != 0) {\n", b" == NULL) ",
            ] * 16
    elif klass == "structured":
        tags = [b"<row id='%d'><val>", b"</val><t>", b"</t></row>\n",
                b"  C   %d.%03d  0  0  0  0  0  0\n", b"$$$$\n", b"M  END\n"]
        for i in range(90):
            t = tags[i % len(tags)]
            pool.append((t.replace(b"%d", str(i).encode())
                         .replace(b"%03d", f"{i:03d}".encode())) * 3)
    elif klass == "binary":
        # the seeded pool of bytes in place of the host's executables
        src = rng.integers(0, 256, 1 << 20).astype(np.uint8)
        for _ in range(1200):
            ln = int(rng.integers(8, 48))
            at = int(rng.integers(0, len(src) - ln))
            pool.append(src[at : at + ln].tobytes())
    elif klass == "records":
        for i in range(600):
            rec = bytearray(rng.integers(0, 256, 38, dtype=np.uint8).tobytes())
            rec[0:6] = b"\x00\x01REC\x00"
            rec[20:26] = (i % 97).to_bytes(2, "little") * 3
            pool.append(bytes(rec))
    elif klass == "smooth16":
        for _ in range(800):
            ln = int(rng.integers(6, 24))
            base = int(rng.integers(0, 4096))
            step = int(rng.integers(0, 7)) - 3
            vals = (base + step * np.arange(ln)) & 0x0FFF
            pool.append(vals.astype("<u2").tobytes())
    elif klass == "noisyrec":
        for _ in range(400):
            rec = bytearray(rng.integers(0, 256, 28, dtype=np.uint8).tobytes())
            rec[0:4] = b"SAO\x00"
            pool.append(bytes(rec))
    elif klass == "noise":
        for _ in range(256):
            pool.append(rng.integers(0, 4096, 16).astype("<u2").tobytes())
    else:
        raise ValueError(klass)
    return pool


def generate(seed: int, name: str, size: int, klass: str, knob: float) -> bytes:
    """One member: Zipf-ranked tiles, a ``knob`` share of the tile slots of
    every chunk replaced by one run of fresh noise of the same mean length.
    The pool of tiles is the member's own and the same for every seed; the
    seed draws the stream of tiles and the noise.  So the bytes change with
    the seed and the work they make (ratio, matches, literals) does not."""
    pool = _tile_pool(klass, _rng("pool", name))
    rng = _rng(seed, name)
    noise_rng = _rng(seed, name, "noise")
    flat = np.frombuffer(b"".join(pool), np.uint8)
    lens = np.array([len(t) for t in pool], np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    mean_len = float(lens.mean())
    a = 1.10 if klass in ("structured", "source") else 0.90
    w = 1.0 / np.arange(1, len(pool) + 1, dtype=np.float64) ** a
    w /= w.sum()

    out = np.empty(size, np.uint8)
    pos = 0
    chunk_tiles = max(1024, int(262_144 / mean_len))
    n_noise = int(knob * chunk_tiles)
    while pos < size:
        idx = rng.choice(len(pool), size=chunk_tiles, p=w)[: chunk_tiles - n_noise]
        tl = lens[idx]
        ends = np.cumsum(tl)
        # byte j of the chunk is byte (j - start of its tile) of its tile
        src = np.repeat(offs[idx] - (ends - tl), tl) + np.arange(int(ends[-1]))
        take = min(len(src), size - pos)
        out[pos : pos + take] = flat[src[:take]]
        pos += take
        nlen = min(int(n_noise * mean_len), size - pos)
        if nlen > 0:
            if klass in ("noise", "smooth16"):
                vals = noise_rng.integers(0, 4096, nlen // 2 + 1).astype("<u2")
                out[pos : pos + nlen] = vals.view(np.uint8)[:nlen]
            else:
                out[pos : pos + nlen] = noise_rng.integers(0, 256, nlen, dtype=np.uint8)
            pos += nlen
    return out.tobytes()


def members(seed: int, scale: float = 1.0) -> dict[str, bytes]:
    """All 12 members in Silesia order, ``scale`` of their sizes (1.0 in
    every measured run; smaller only for tests on the CPU)."""
    return {n: generate(seed, n, max(1, int(size * scale)), klass, knob)
            for n, size, _ratio, klass, knob in SILESIA}
