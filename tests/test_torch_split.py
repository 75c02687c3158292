"""The split parse of ``csrc/compress.cu`` (one row on many warps) by its
plain version, ``kernels.compress.parse_split_plain``: byte-equal to the
serial greedy parse ``parse_plain``, with the serial status, on rows cut
at seams just over 64 KiB apart; the stitch's chains; the counters; and
the route ``parallel.blocks.scalar_launch`` takes in each frame mode.
"""

import random

import numpy as np
import pytest
import torch

import lz4tpu_torch as lt
from lz4bench.corpora import silesia
from lz4tpu_torch.kernels import compress as kc
from lz4tpu_torch.kernels.status import STATUS_INCOMPRESSIBLE, STATUS_OK
from lz4tpu_torch.parallel import blocks
from lz4tpu_torch.spec.block import compress_bound

SEAM = (1 << 16) + 4096  # just over the window: many seams, many takeovers
SEED = 3_141_592_653


@pytest.fixture(scope="module")
def members():
    return silesia.members(SEED, 0.06)


def _noise(n: int, seed: int = 1) -> bytes:
    return random.Random(seed).randbytes(n)


def _rows(members):
    """name -> (row, cap, acceleration)."""
    text = members["dickens"][: 512 << 10]
    web = members["webster"][: 448 << 10]
    motif = members["xml"][:1000]
    return {
        "text": (text, -1, 1),
        "text_accel2": (web, -1, 2),
        "text_accel8": (text[: 320 << 10], -1, 8),
        # a noise stretch longer than any overlap between two text stretches
        "noise_stretch": (text[: 96 << 10] + _noise(300 << 10) + text[96 << 10 : 256 << 10], -1,
                          1),
        # one match of 200 KiB across the first three seams
        "seam_in_a_long_match": (text[: 40 << 10] + motif * 200 + text[40 << 10 : 300 << 10],
                                 -1, 1),
        "all_zero": (bytes(384 << 10), -1, 1),
        "over_its_cap": (_noise(256 << 10, 2), 256 << 10, 1),
        # a partial last block: the last segment longer than the others
        "partial_last": (web[: 5 * SEAM + 12_345], 5 * SEAM + 12_345, 1),
    }


CASES = ["text", "text_accel2", "text_accel8", "noise_stretch", "seam_in_a_long_match",
         "all_zero", "over_its_cap", "partial_last"]


@pytest.mark.parametrize("case", CASES)
def test_split_parse_equals_the_serial_parse(case, members):
    row, cap, accel = _rows(members)[case]
    width = compress_bound(len(row)) + 16
    want, want_status = kc.parse_plain(row, 0, cap, accel, 0, False, [0] * 4096, False, width)
    got, length, status, seams, taken = kc.parse_split_plain(row, cap, accel, SEAM, width)
    assert status == want_status
    assert seams == kc.segments(len(row), SEAM) - 1 >= 2
    assert 0 <= taken <= seams
    if status == STATUS_OK:
        assert got == want and length == len(want)
    else:
        assert got == b"" and length > (width if cap < 0 else cap)


def test_one_row_over_the_cap_by_one_byte(members):
    """The stitched length passes the cap exactly where the serial parse
    aborts: one byte of cap either side of the parse's length."""
    row = members["dickens"][: 300 << 10]
    width = compress_bound(len(row)) + 16
    size = len(kc.parse_plain(row, 0, -1, 1, 0, False, [0] * 4096, False, width)[0])
    for cap, want in ((size, STATUS_OK), (size - 1, STATUS_INCOMPRESSIBLE)):
        assert kc.parse_plain(row, 0, cap, 1, 0, False, [0] * 4096, False, width)[1] == want
        assert kc.parse_split_plain(row, cap, 1, SEAM, width)[2] == want


def test_hand_offs_and_takeovers_both_happen(members):
    """Text hands most seams over to the next segment; a noise stretch
    forces takeovers."""
    rows = _rows(members)
    width = compress_bound(1 << 20)
    text = kc.parse_split_plain(rows["text"][0], -1, 1, SEAM, width)
    noise = kc.parse_split_plain(rows["noise_stretch"][0], -1, 1, SEAM, width)
    assert text[4] < text[3]
    assert noise[4] > 0


def _exact_runs(row: bytes, firsts, handoffs, keep=None):
    """Runs that all follow the serial parse, so that a hand-off between
    two of them at a common search start is true: run ``k`` from the
    search start ``firsts[k]``, with ``handoffs[k]`` = (target, h) or
    ``None`` and at most ``keep`` records."""
    from lz4tpu_torch.spec.table import hash_all_u32

    hashes = hash_all_u32(row).tolist()
    seqs = list(kc._sequences(row, hashes, 0, 0, 1, 0, [0] * 4096, 0xFFFFFFFF))
    runs, ops = [], []
    for first in firsts:
        run = kc._Run(first)
        at = {}
        for s in seqs:
            if s[0] >= first:
                at[s[0]] = len(run.out)
                run.records.append((s[1], s[2], s[3], len(run.out)))
                kc._put_group(run.out, row, s)
        runs.append(run)
        ops.append(at)
    for k, hand in enumerate(handoffs):
        if hand is not None:
            tgt, h = hand
            runs[k].handoff = (tgt, h, ops[k][h], ops[tgt][h])
        if keep is not None:
            runs[k].records = runs[k].records[:keep]
    return runs, [s[0] for s in seqs]


@pytest.mark.parametrize("keep", [None, 3])
def test_stitch_follows_chains(keep, members):
    """A hand-off into a segment past that segment's own hand-off (h < e)
    goes on in the segment it handed over to, from the same point; past a
    run's records the offset comes from its tokens."""
    row = members["dickens"][: 200 << 10]
    starts = _exact_runs(row, [0], [None])[1]
    pick = lambda at: next(p for p in starts if p >= at)  # noqa: E731
    firsts = [0, pick(40_000), pick(80_000), pick(120_000)]
    h1, h0, h2 = pick(90_000), pick(100_000), pick(140_000)
    # 0 -> 1 at h0; 1 handed over to 2 before that, at h1; 2 -> 3 at h2
    runs, _ = _exact_runs(row, firsts, [(1, h0), (2, h1), (3, h2), None], keep)
    want = kc.parse_plain(row, 0, -1, 1, 0, False, [0] * 4096, False, 1 << 20)[0]
    pieces, hops = kc.stitch_pieces(runs)
    assert b"".join(bytes(runs[k].out[a:b]) for k, a, b in pieces) == want
    assert [k for k, _, _ in pieces] == [0, 2, 3]
    assert hops == 3


def test_rows_of_a_split_launch(members):
    """``compress_split_plain`` over a full row and a short one: each row
    equal to ``compress_plain``'s, the short one in one segment."""
    rows = [members["webster"][: 4 * SEAM], members["dickens"][: SEAM + 5]]
    width = compress_bound(len(rows[0])) + 16
    data = torch.zeros((2, len(rows[0])), dtype=torch.uint8)
    for i, r in enumerate(rows):
        data[i, : len(r)] = torch.frombuffer(bytearray(r), dtype=torch.uint8)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    n = i32([len(r) for r in rows])
    zeros = i32([0, 0])
    want = kc.compress_plain(data, n, zeros, n, i32([1, 1]), zeros, zeros,
                             torch.zeros((2, 4096), dtype=torch.int32), width)
    out, out_len, status, counts = kc.compress_split(data, n, n, i32([1, 1]), SEAM,
                                                     kc.split_plan([len(r) for r in rows], SEAM),
                                                     width)
    assert torch.equal(status, want[2]) and torch.equal(out_len, want[1])
    assert torch.equal(out, want[0])
    assert counts[0].tolist() == [3, 0]


def test_seam_rule():
    mib4 = 4 << 20
    # a large launch on 132 multiprocessors: WARPS_PER_SM each
    seam = kc.split_seam([mib4] * 40, 132)
    assert seam == 40 * mib4 // (132 * kc.WARPS_PER_SM) // 4096 * 4096 > kc.SEAM_FLOOR
    # a small launch stays at the floor; rows under two segments stay whole
    assert kc.split_seam([mib4], 132) == kc.SEAM_FLOOR
    assert kc.split_seam([2 * kc.SEAM_FLOOR - 1], 132) is None
    # and so do rows that end before a hand-off is likely: -B5's 256 KiB
    # rows, 512 and 768 KiB ones; -B6's 1 MiB rows split
    assert kc.split_seam([256 << 10] * 40, 132) is None
    assert kc.split_seam([512 << 10] * 8, 132) is None
    assert kc.split_seam([768 << 10] * 8, 132) is None
    assert kc.split_seam([1 << 20] * 17, 132) == kc.SEAM_FLOOR
    reach = kc.SEAM_FLOOR + kc.SPLIT_REACH
    assert kc.split_seam([reach], 132) == kc.SEAM_FLOOR
    assert kc.split_seam([reach - 1] * 3, 132) is None
    assert kc.split_seam([64 << 10] * 50, 132) is None
    assert kc.split_seam([], 132) is None
    # never more than MAX_SEGMENTS a row
    assert kc.segments(mib4, kc.split_seam([mib4], 1 << 10)) <= kc.MAX_SEGMENTS
    plan = kc.split_plan([mib4, 3 * kc.SEAM_FLOOR, 100], kc.SEAM_FLOOR)
    k = mib4 // kc.SEAM_FLOOR
    assert plan.row_first.tolist() == [0, k, k + 3, k + 4]
    assert plan.warps[:, 1].tolist() == list(range(k)) + [0, 1, 2, 0]
    assert plan.records == int(plan.warps[:, 5].sum())
    assert plan.scratch_bytes == int(plan.warps[:, 3].sum())


def _spy(monkeypatch, calls):
    for name in ("compress_batch", "compress_split"):
        real = getattr(blocks, name)

        def spy(rows, *a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(rows, *a, **k)

        monkeypatch.setattr(blocks, name, spy)


@pytest.mark.parametrize("mode", ["independent", "linked", "dictionary", "64k", "many_blocks",
                                  "short_row"])
def test_route(mode, monkeypatch, members):
    """Independent rows without a dictionary that the launch gives two
    segments and ``SPLIT_REACH`` past the first seam take the split parse;
    linked rows, dictionary rows, 64 KiB rows and shorter rows take the
    one-warp kernel, as ``scalar_route`` names it.  On the CPU a launch
    aims at ``WARPS_PER_SM`` warps in all, so a frame of nine 256 KiB
    blocks stays whole, and so does one row of 640 KiB (seams 160 KiB
    apart)."""
    data = members["webster"][: 1 << 20]
    kwargs = dict(device="cpu")
    block = 1 << 20
    if mode == "linked":
        kwargs["parallel_linked"] = True
    elif mode == "dictionary":
        kwargs["dictionary"] = members["webster"][: 32 << 10]
    elif mode == "64k":
        data, block = data[: 256 << 10], 1 << 16
    elif mode == "many_blocks":
        data, block = members["webster"][: (9 << 18) - 1000], 1 << 18
    elif mode == "short_row":
        data = data[: 640 << 10]
    calls = []
    _spy(monkeypatch, calls)
    frame = lt.compress_frame_parallel(data, block, **kwargs)
    want = "compress_split" if mode == "independent" else "compress_batch"
    assert calls == [want]
    route = blocks.scalar_route(blocks.block_lens(len(data), block), kwargs.get("dictionary"),
                                kwargs.get("parallel_linked", False), "cpu")
    assert route[0] == ("compress_split" if mode == "independent" else "compress")
    assert (route[1] is None) == (mode != "independent")
    extra = {"dictionary": kwargs["dictionary"]} if "dictionary" in kwargs else {}
    assert lt.decompress_frame(frame, engine="native", **extra) == data


def test_counters_count_seams_and_takeovers(members):
    """``stats()`` counts a split launch's seams and the seams taken over,
    as the plain version's rows report them.  The rows reach a seam plus
    ``SPLIT_REACH``, so that the route splits them; a noise stretch forces
    takeovers."""
    web = members["webster"]
    rows = [web[: 1 << 20], web[: 256 << 10] + _noise(400 << 10) + web[256 << 10 : 624 << 10]]
    lt.reset_stats()
    for row in rows:
        frame = lt.compress_frame_parallel(row, 1 << 20, device="cpu")
        assert lt.decompress_frame(frame, engine="native") == row
    got = lt.stats()
    want_seams = want_taken = 0
    for row in rows:
        seam = kc.split_seam([len(row)], 1)
        _, _, _, seams, taken = kc.parse_split_plain(row, len(row), 1, seam,
                                                     kc.round_up((1 << 20) + 16, 16))
        want_seams += seams
        want_taken += taken
    assert got["compress_seams"] == want_seams >= 2
    assert got["compress_seams_taken_over"] == want_taken > 0
    np.testing.assert_equal(got["launches"].get("compress_split", 0), 0)  # plain: no launches
