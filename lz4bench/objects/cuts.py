"""Objects ``cuts``: ``count`` pieces cut from the corpus's members, with
sizes log-uniform between ``sizes[0]`` and ``sizes[1]`` bytes.

The sizes, and the member each piece is cut from, are drawn under the mix's
name alone, so every seed has the same set of sizes; the seed draws where
in its member each piece starts.  A piece is at most its member's length.
"""

import numpy as np

from lz4bench import traffic


def make(corpus: dict[str, bytes], mix: dict, seed: int) -> list[tuple[str, bytes]]:
    names = list(corpus)
    fixed = traffic.rng(None, "cuts", mix["name"])
    lo, hi = mix["sizes"]
    sizes = np.exp(fixed.uniform(np.log(lo), np.log(hi), mix["count"])).astype(np.int64)
    which = fixed.integers(0, len(names), mix["count"])
    at = traffic.rng(seed, "cuts", mix["name"])
    out = []
    for i, (k, size) in enumerate(zip(which.tolist(), sizes.tolist())):
        data = corpus[names[k]]
        size = min(size, len(data))
        start = int(at.integers(0, len(data) - size + 1))
        out.append((f"{names[k]}@{start}+{size}#{i}", data[start : start + size]))
    return out
