"""The seeded Silesia stand-in (``corpora/silesia.py``): bytes by seed, sizes, ratios."""

import pytest

from lz4bench import liblz4
from lz4bench.corpora import silesia as corpus


def test_same_seed_same_bytes_other_seed_other_bytes():
    a = corpus.members(2**31 + 17, scale=0.002)
    assert a == corpus.members(2**31 + 17, scale=0.002)
    b = corpus.members(2**31 + 18, scale=0.002)
    assert all(a[n] != b[n] for n in corpus.NAMES)
    assert [len(a[n]) for n in corpus.NAMES] == [len(b[n]) for n in corpus.NAMES]


def test_full_sizes_and_ratios_are_the_members():
    """Every member at its Silesia size; its ratio through the lz4 CLI's 4 MiB
    frames within 0.01 of the published one, on a seed the knobs were not
    calibrated on."""
    m = corpus.members(5)
    assert sum(map(len, m.values())) == corpus.TOTAL_BYTES == 211_938_580
    for name, size, ratio, _klass, _knob in corpus.SILESIA:
        assert len(m[name]) == size
        frame = liblz4.compress_frame(m[name], block_size=1 << 22, independent=True,
                                      content_checksum=True, block_checksums=False,
                                      content_size=False, level=1)
        assert abs(len(frame) / size - ratio) < 0.01, name


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 5, 10**12])
def test_any_whole_seed(seed):
    assert len(corpus.generate(seed, "xml", 5000, "structured", 0.1491)) == 5000
