"""Silesia stand-in corpus (the port's own copy of the generator).

The Silesia corpus (https://sun.aei.polsl.pl/~sdeor/index.php?page=silesia)
is the data size LZ4 users call real: 12 members, 211,938,580 bytes.  This
module synthesizes a documented stand-in from numpy alone: one generated
file per Silesia member, matching

* the member's exact original size (scaled by ``scale``),
* its texture class (English text / executable / medical image / database
  / source code / XML / near-incompressible scientific data), and
* its LZ4-greedy compression ratio, calibrated against liblz4
  ``LZ4_compress_default`` to the published per-file ratios (lzbench,
  lz4 1.9.x default level) — the ``lz4_ratio`` column below; the frozen
  ``knob`` column is the calibration output (tools/calibrate_silesia.py)
  and makes generation deterministic with no liblz4 dependency.

Texture model: a stream is a Zipf-sampled concatenation of "tiles" from a
per-file pool (repeated tiles become LZ4 matches at realistic distances;
pool size and tile length set the match-length/offset profile) blended
with fresh high-entropy runs (the ``knob`` = noise fraction, the ratio
control).  Binary-class members additionally draw tiles from ELF
executables found on the host (instruction-stream texture; a seeded
random pool where none is found).  With ``cache=True`` the result is
cached under ``.bench_corpus/`` at the repository root, keyed by
(member, scale) — the same files the JAX package's generator writes.

Byte-for-byte identical to ``lz4tpu.utils.silesia`` on the same host.
"""

from __future__ import annotations

import hashlib
import pathlib

import numpy as np

# name, original bytes, target LZ4-default ratio (comp/orig, approximate
# published lzbench values), texture class, calibrated noise knob
SILESIA = [
    # knobs frozen by tools/calibrate_silesia.py @ 3 MiB samples;
    # "achieved" = the stand-in's measured LZ4_compress_default ratio
    ("dickens", 10_192_446, 0.632, "text", 0.2334),  # achieved 0.6296
    ("mozilla", 51_220_480, 0.512, "binary", 0.2750),  # achieved 0.5156
    ("mr", 9_970_564, 0.546, "smooth16", 0.4123),  # achieved 0.5413
    ("nci", 33_553_445, 0.164, "structured", 0.0845),  # achieved 0.1662
    ("ooffice", 6_152_192, 0.705, "binary", 0.5350),  # achieved 0.7032
    ("osdb", 10_085_684, 0.521, "records", 0.3566),  # achieved 0.5197
    ("reymont", 6_627_202, 0.519, "text", 0.0375),  # achieved 0.5148
    ("samba", 21_606_400, 0.359, "source", 0.1575),  # achieved 0.3627
    ("sao", 7_251_944, 0.934, "noisyrec", 0.8810),  # achieved 0.9342
    ("webster", 41_458_703, 0.489, "text", 0.0042),  # achieved 0.4925
    ("x-ray", 8_474_240, 0.991, "noise", 0.9619),  # achieved 0.9943
    ("xml", 5_345_280, 0.224, "structured", 0.1539),  # achieved 0.2246
]

TOTAL_BYTES = sum(s for _, s, _, _, _ in SILESIA)  # 211,938,580

_BIN_SOURCES = [
    "/usr/bin/g++",
    "/usr/lib/x86_64-linux-gnu/libc.so.6",
    "/usr/lib/x86_64-linux-gnu/libstdc++.so.6",
]

_CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".bench_corpus"


def _rng(name: str, salt: str = "") -> np.random.Generator:
    h = hashlib.sha256(f"silesia:{name}:{salt}".encode()).digest()
    return np.random.default_rng(int.from_bytes(h[:8], "little"))


def _tile_pool(name: str, klass: str, rng) -> list[bytes]:
    """Per-class pool of byte tiles; repeated sampling of one tile is what
    LZ4 sees as a match, so tile lengths set the match-length profile."""
    pool = []
    if klass in ("text", "source"):
        # word-/line-like tiles over a letter alphabet
        letters = np.frombuffer(
            b"etaoinshrdlucmfwypvbgkqjxz    \n", dtype=np.uint8
        )
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
        # markup/table rows: long highly-repetitive tiles (nci/xml style)
        tags = [b"<row id='%d'><val>", b"</val><t>", b"</t></row>\n",
                b"  C   %d.%03d  0  0  0  0  0  0\n", b"$$$$\n", b"M  END\n"]
        for i in range(90):
            t = tags[i % len(tags)]
            pool.append((t.replace(b"%d", str(i).encode())
                          .replace(b"%03d", f"{i:03d}".encode())) * 3)
    elif klass == "binary":
        srcs = []
        for p in _BIN_SOURCES:
            try:
                srcs.append(np.frombuffer(open(p, "rb").read(), np.uint8))
            except OSError:
                pass
        if not srcs:  # deterministic fallback off-image
            srcs = [rng.integers(0, 256, 1 << 20).astype(np.uint8)]
        for _ in range(1200):
            src = srcs[int(rng.integers(len(srcs)))]
            ln = int(rng.integers(8, 48))
            at = int(rng.integers(0, len(src) - ln))
            pool.append(src[at : at + ln].tobytes())
    elif klass == "records":
        # database rows: fixed-stride records, some fields constant
        for i in range(600):
            rec = bytearray(rng.integers(0, 256, 38, dtype=np.uint8).tobytes())
            rec[0:6] = b"\x00\x01REC\x00"
            rec[20:26] = (i % 97).to_bytes(2, "little") * 3
            pool.append(bytes(rec))
    elif klass == "smooth16":
        # medical-image style: low-frequency 16-bit ramps (weak matches)
        for _ in range(800):
            ln = int(rng.integers(6, 24))
            base = int(rng.integers(0, 4096))
            step = int(rng.integers(0, 7)) - 3
            vals = (base + step * np.arange(ln)) & 0x0FFF
            pool.append(vals.astype("<u2").tobytes())
    elif klass == "noisyrec":
        # star-catalog style: binary records, mostly-random payload
        for _ in range(400):
            rec = bytearray(rng.integers(0, 256, 28, dtype=np.uint8).tobytes())
            rec[0:4] = b"SAO\x00"
            pool.append(bytes(rec))
    elif klass == "noise":
        # x-ray: 12-bit samples in 16-bit words — nearly incompressible
        for _ in range(256):
            vals = rng.integers(0, 4096, 16).astype("<u2")
            pool.append(vals.tobytes())
    else:  # pragma: no cover
        raise ValueError(klass)
    return pool


def _generate(name: str, size: int, klass: str, knob: float) -> bytes:
    """Zipf-tile stream blended with fresh noise runs (fraction ``knob``)."""
    rng = _rng(name)
    pool = _tile_pool(name, klass, rng)
    flat = np.frombuffer(b"".join(pool), np.uint8)
    offs = np.zeros(len(pool) + 1, np.int64)
    np.cumsum([len(t) for t in pool], out=offs[1:])
    lens = offs[1:] - offs[:-1]
    mean_len = float(lens.mean())

    # Zipf-ranked tile popularity: rank r sampled with weight 1/r^a
    a = 1.10 if klass in ("structured", "source") else 0.90
    ranks = np.arange(1, len(pool) + 1, dtype=np.float64)
    w = 1.0 / ranks**a
    w /= w.sum()

    out = np.empty(size + 4096, np.uint8)
    pos = 0
    chunk_tiles = max(1024, int(262_144 / mean_len))
    noise_rng = _rng(name, "noise")
    while pos < size:
        idx = rng.choice(len(pool), size=chunk_tiles, p=w)
        # a ``knob`` fraction of tile slots is REPLACED by fresh noise of
        # the same mean length (never re-sampled -> pure literals for LZ4)
        n_noise = int(knob * chunk_tiles)
        for t in idx[: chunk_tiles - n_noise].tolist():
            ln = int(lens[t])
            if pos + ln > len(out):
                break
            out[pos : pos + ln] = flat[offs[t] : offs[t] + ln]
            pos += ln
        # noise runs appended in one vector op per chunk (positions don't
        # need to interleave exactly — LZ4 sees the same literal fraction)
        nlen = int(n_noise * mean_len)
        if nlen and pos + nlen <= len(out):
            if klass in ("noise", "smooth16", "mr"):
                vals = noise_rng.integers(0, 4096, nlen // 2 + 1).astype("<u2")
                nb = vals.tobytes()[:nlen]
            else:
                nb = noise_rng.integers(0, 256, nlen, dtype=np.uint8).tobytes()
            out[pos : pos + nlen] = np.frombuffer(nb, np.uint8)
            pos += nlen
    return out[:size].tobytes()


def member(name: str, scale: float = 1.0, cache: bool = True) -> bytes:
    """One Silesia member stand-in at ``scale`` of its original size."""
    for n, size, _ratio, klass, knob in SILESIA:
        if n == name:
            sz = int(size * scale)
            if cache:
                _CACHE_DIR.mkdir(exist_ok=True)
                f = _CACHE_DIR / f"{name}_{sz}.bin"
                if f.exists() and f.stat().st_size == sz:
                    return f.read_bytes()
                data = _generate(name, sz, klass, knob)
                tmp = f.with_suffix(".tmp")
                tmp.write_bytes(data)
                tmp.replace(f)
                return data
            return _generate(name, sz, klass, knob)
    raise KeyError(name)


def corpus(scale: float = 1.0, cache: bool = True) -> dict[str, bytes]:
    """The full 12-member stand-in corpus, in Silesia order."""
    return {n: member(n, scale, cache) for n, *_ in SILESIA}
