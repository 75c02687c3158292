#!/usr/bin/env python3
"""The lane compressor's size contract on the CPU: its total over the
Silesia stand-in in 32 KiB blocks against the greedy parse's, by member.

    python3 tools/torch_lane_ratio.py [--scale 0.004] [--root DIR]

Runs the plain versions (``device="cpu"``) of ``compress_blocks_128`` and
``compress_blocks``; ``--root`` imports ``lz4tpu_torch`` from another
checkout (a parent commit unpacked with ``git archive``), so that two
definitions of the lane parse can be compared on the same blocks.
"""

import argparse
import pathlib
import sys


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=0.004, help="Silesia stand-in scale")
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parents[1]),
                    help="checkout to import lz4tpu_torch from")
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import lz4tpu_torch as lt
    from lz4tpu_torch.utils import silesia

    lane_total = greedy_total = 0
    for name, data in silesia.corpus(args.scale, cache=False).items():
        blocks = [data[i : i + (32 << 10)] for i in range(0, len(data), 32 << 10)]
        lane = sum(map(len, lt.compress_blocks_128(blocks, device="cpu")))
        greedy = sum(len(c) for c in lt.compress_blocks(blocks, device="cpu")[0])
        lane_total += lane
        greedy_total += greedy
        print(f"{name:8s} {len(blocks):5d} blocks: lane {lane:>10,d} B, greedy {greedy:>10,d} B "
              f"({lane / greedy:.4f})")
    print(f"total: lane {lane_total:,d} B, greedy {greedy_total:,d} B "
          f"({lane_total / greedy_total:.4f})")


if __name__ == "__main__":
    main()
